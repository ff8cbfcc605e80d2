"""The port's ShardedEngine (tgb_tgn_dgl_tpu_torch/parallel/engine.py) on
the CPU over gloo, against the port's serial ``Engine`` and the JAX
package's ``ShardedEngine``, at the sizes of tests/test_parallel.py (a
1,024-event, 128-node stream, D = 32, 4 heads, batch 128, mailbox 2).

The ranks are processes started from a worker script written to
``tmp_path`` (they import no JAX), joined by a gloo process group through
a ``file://`` store; each writes what it measured to ``tmp_path``.  One
run of 4 ranks (dp = 2, state = 2, dropout 0) and one of 2 ranks
(dp = 1, state = 2, the config's dropout 0.2) serve several tests, and a
2-rank ``fit`` run (dp = 2, state = 1) serves the ``fit`` tests.

  * ``make_mesh`` lays out what JAX ``make_mesh`` does;
  * world size 1 (in this process, a gloo group of one) is the serial
    Engine bit for bit: frozen, memory and JODIE at dropout 0.2;
  * dp = 1, state = 2 is the serial Engine bit for bit (memory);
  * dp = 2, state = 2 at dropout 0 (memory, frozen): epoch losses and val
    MRR within rtol 2e-4 of the serial port and of the JAX ShardedEngine
    on make_mesh(4, dp=2, state=2) from the same weights; a second
    epoch's loss is lower; the slot-unique MRR within 1e-6 of the serial
    port's (bit-equal here: every rank embeds its rows with the serial
    arithmetic and the ranks are integer counts), and the column-chunk
    pass equal to the slot-unique one from the same state;
  * a checkpoint saved and loaded at dp = 2, state = 2 continues to the
    uninterrupted run's epoch and val MRR (rel 1e-5);
  * ``fit``: eval_every, patience with the best parameters restored on
    every rank, a checkpoint an epoch, the val snapshot, and the log lines
    and ``metrics.jsonl`` from rank 0 alone;
  * the refusals; the CLI in-process at world size 1.
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from tgb_tgn_dgl_tpu.data.dataset import synthetic as jax_synthetic
from tgb_tgn_dgl_tpu.parallel import mesh as jax_mesh
from tgb_tgn_dgl_tpu.parallel.engine import ShardedEngine as JaxShardedEngine
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.bridge import params_to_jax
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.parallel.engine import ShardedEngine
from tgb_tgn_dgl_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

ROOT = Path(__file__).resolve().parents[1]
DATA = dict(name="tiny-sharded", num_edges=1024, num_nodes=128, msg_dim=8,
            num_neg=6, seed=7)
FIT_DATA = dict(name="sharded-fit", num_edges=768, num_nodes=96, msg_dim=4,
                num_neg=4, seed=5)
RTOL = 2e-4          # tests/test_parallel.py:126-127
MRR_ATOL = 1e-6
CKPT_REL = 1e-5      # tests/test_parallel.py:320
GRAD_RTOL = 1e-5     # the first step's gradient vector, norm-relative


def _raw(family, dropout=0.0, **train):
    frozen = family == "frozen"
    mem = dict(dim_out=32, dim_time=32, mailbox_size=2)
    arch = "transformer_attention"
    if family == "jodie":
        mem["memory_update"] = "rnn"
        arch = "identity"
    return dict(sampling=[dict(neighbor=[5])], memory=[mem],
                gnn=[dict(arch=arch, dim_out=32, att_head=4, dim_time=32)],
                train=[dict(batch_size=128, lr=1e-3, dropout=dropout,
                            att_dropout=dropout, frozen_memory=frozen,
                            seed=3, **train)])


_WORKER = r"""
import json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.engine.checkpoint import EarlyStopMonitor
from tgb_tgn_dgl_tpu_torch.parallel.engine import ShardedEngine
from tgb_tgn_dgl_tpu_torch.parallel.mesh import make_mesh
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict
dist.init_process_group("gloo", init_method="file://" + tmp + "/store",
                        world_size=world, rank=rank)
spec = json.load(open(os.path.join(tmp, "spec.json")))
mesh = make_mesh(world, spec["dp"], spec["state"])
out = []
for job in spec["jobs"]:
    def engine():
        return ShardedEngine(synthetic(**job["data"]),
                             parse_config_dict(job["raw"]), mesh=mesh,
                             device="cpu")
    eng, rec = engine(), []
    for op, *args in job["ops"]:
        if op == "epoch":
            rec.append(eng.train_epoch()["loss"])
        elif op in ("val", "test"):
            rec.append((eng.evaluate(op), eng.last_eval_trace["protocol"]))
        elif op == "chunked":
            rec.append(eng._evaluate_chunked("val"))
        elif op == "snap":
            snap = eng.snapshot_stream()
        elif op == "restore":
            eng.restore_stream(snap)
        elif op == "save":
            rec.append(eng.save_checkpoint(os.path.join(tmp, args[0])))
        elif op == "fresh":
            eng = engine()
        elif op == "load":
            eng.load_checkpoint(os.path.join(tmp, args[0]))
        elif op == "capture":
            # the gradients the optimizer is handed first (after the dp sum)
            grads, step = {}, eng.optimizer.step

            def first(*a, step=step, grads=grads, eng=eng, **k):
                if not grads:
                    grads.update({n: p.grad.clone() for n, p in
                                  eng.model.named_parameters()
                                  if p.grad is not None})
                return step(*a, **k)
            eng.optimizer.step = first
        elif op == "grads":
            rec.append(grads)
        elif op == "state":
            mem = eng.full_memory_state() if eng.use_memory else None
            rec.append(dict(params=eng.model.state_dict(),
                            mem=None if mem is None else mem._asdict(),
                            packer=eng.packer.snapshot()))
        elif op == "fit":
            # one fit call an entry of "calls" (its epochs), all with one
            # early-stop monitor, as the CLI's --profile path calls it
            kw = dict(args[0])
            calls = kw.pop("calls")
            kw["log_dir"] = kw["checkpoint_dir"] = os.path.join(
                tmp, kw.pop("dir"))
            kw["early_stop"] = EarlyStopMonitor(
                max_round=kw.pop("patience"),
                tolerance=kw.pop("tolerance", 1e-10), save_dir=kw["log_dir"])
            lines, hists = [], []
            for epochs in calls:
                hists.append(eng.fit(epochs=epochs, log=lines.append, **kw))
            rec.append(dict(hist=hists[0], hists=hists, lines=lines,
                            epoch=eng._epoch, params=eng.model.state_dict()))
    out.append(rec)
torch.save(out, os.path.join(tmp, "out%d.pt" % rank))
dist.destroy_process_group()
"""


def _run_ranks(tmp, dp, state, jobs):
    """Run ``jobs`` on dp x state worker processes; returns every rank's
    records (one list a job)."""
    world = dp * state
    (tmp / "worker.py").write_text(_WORKER)
    (tmp / "spec.json").write_text(json.dumps(dict(dp=dp, state=state,
                                                   jobs=jobs)))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(world),
         str(tmp)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [f"rank {r} failed:\n{text[-4000:]}"
              for r, (p, text) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, "\n".join(failed)
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(world)]


@contextlib.contextmanager
def _one_thread():
    """The workers' thread count: CPU reductions split over threads sum in
    another order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tests_on_one_thread():
    """Every test here on one thread, as the workers run: tiny models gain
    nothing from more, and the test run's parallel workers share the
    cores."""
    with _one_thread():
        yield


def _serial(family, dropout=0.0, data=DATA):
    return Engine(synthetic(**data), parse_config_dict(_raw(family, dropout)),
                  device="cpu")


def _assert_params_equal(a, b):
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


def _assert_mem_equal(eng, mem):
    for f, t in zip(eng.mem_state._fields, eng.mem_state):
        assert torch.equal(t, mem[f]), f


# ---------------------------------------------------------- the 4-rank run
DP2_OPS = [["capture"], ["epoch"], ["save", "ckpt.pt"], ["snap"], ["val"],
           ["restore"], ["chunked"], ["epoch"], ["val"], ["test"], ["state"]]
RESUME_OPS = [["load", "ckpt.pt"], ["chunked"], ["epoch"], ["val"]]


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """dp = 2, state = 2, dropout 0: memory (then resumed from its epoch-1
    checkpoint) and frozen."""
    tmp = tmp_path_factory.mktemp("dp2")
    jobs = [dict(raw=_raw("memory"), data=DATA, ops=DP2_OPS + [["grads"],
                                                               ["fresh"]]
                 + RESUME_OPS),
            dict(raw=_raw("frozen"), data=DATA, ops=DP2_OPS + [["grads"]])]
    return _run_ranks(tmp, 2, 2, jobs)


@pytest.fixture(scope="module")
def serial_runs():
    """The serial port Engine over the same sequence (epoch, val, epoch,
    val, test) from the same seed, and its initial parameters."""
    out = {}
    # module-scoped, so outside the autouse fixture: the workers' count
    with _one_thread():
        for family in ("memory", "frozen"):
            eng = _serial(family)
            init = {k: v.clone() for k, v in eng.model.state_dict().items()}
            grads, step = {}, eng.optimizer.step

            def first(*a, step=step, grads=grads, eng=eng, **k):
                if not grads:
                    grads.update({n: p.grad.clone() for n, p in
                                  eng.model.named_parameters()
                                  if p.grad is not None})
                return step(*a, **k)
            eng.optimizer.step = first
            l1 = eng.train_epoch()["loss"]
            v1 = eng.evaluate("val")
            l2 = eng.train_epoch()["loss"]
            v2 = eng.evaluate("val")
            out[family] = dict(init=init, loss=(l1, l2), val=(v1, v2),
                               test=eng.evaluate("test"), grads=grads)
    return out


def _unpack(rec):
    (l1, _, (vu, pu), vc, l2, (v2, _), (t2, _), state) = rec[:8]
    return dict(loss=(l1, l2), val_unique=vu, protocol=pu, val_chunked=vc,
                val2=v2, test=t2, state=state)


@pytest.mark.parametrize("family", ["memory", "frozen"])
def test_dp2_state2_matches_the_serial_engine(dp2, serial_runs, family):
    job = 0 if family == "memory" else 1
    got = _unpack(dp2[0][job])
    want = serial_runs[family]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose([got["val_unique"], got["val2"]], want["val"],
                               rtol=RTOL)
    np.testing.assert_allclose(got["test"], want["test"], rtol=RTOL)
    assert got["loss"][1] < got["loss"][0]
    # every rank reports the same numbers
    for rank in dp2[1:]:
        assert _unpack(rank[job])["loss"] == got["loss"]
        assert _unpack(rank[job])["val2"] == got["val2"]


@pytest.mark.parametrize("family", ["memory", "frozen"])
def test_dp2_first_step_gradients_are_the_serial_ones(dp2, serial_runs,
                                                      family):
    """The gradient vector Adam takes at the first step, on every rank
    (after the sum over dp), within GRAD_RTOL of the serial engine's in
    norm, over every parameter at once.  Adam barely feels a gradient's
    scale, so the losses alone can hide a wrong reduction: a gradient
    averaged over dp in place of the sum is a gap of 0.5 here."""
    want = serial_runs[family]["grads"]
    for rank in dp2:
        got = rank[0 if family == "memory" else 1][8]
        assert set(got) == set(want)
        diff = torch.cat([(got[k] - w).reshape(-1) for k, w in want.items()])
        norm = torch.cat([w.reshape(-1) for w in want.values()]).norm()
        assert float(diff.norm()) <= GRAD_RTOL * float(norm)


@pytest.mark.parametrize("family", ["memory", "frozen"])
def test_dp2_slot_unique_eval_matches_serial_and_column_chunks(
        dp2, serial_runs, family):
    """The slot-unique val MRR within 1e-6 of the serial port's (JAX holds
    it bit-equal, tests/test_parallel.py:203-246; here it is bit-equal
    too), and the column-chunk pass from the same state equal to it
    (tests/test_parallel.py:287)."""
    got = _unpack(dp2[0][0 if family == "memory" else 1])
    assert got["protocol"] == "slot_unique"
    assert abs(got["val_unique"] - serial_runs[family]["val"][0]) <= MRR_ATOL
    assert abs(got["val_chunked"] - got["val_unique"]) <= MRR_ATOL


@pytest.fixture(scope="module")
def jax_runs(serial_runs):
    """The JAX ShardedEngine on make_mesh(4, dp=2, state=2) from the port's
    initial weights: epoch, val, epoch."""
    out = {}
    for family in ("memory", "frozen"):
        raw = _raw(family, eval_slot_unique=True, fuse_steps=0)
        eng = JaxShardedEngine(jax_synthetic(**DATA), jax_config(raw),
                               mesh=jax_mesh.make_mesh(4, dp=2, state=2))
        eng.params = jax.tree.map(jnp.asarray, params_to_jax(
            serial_runs[family]["init"]))
        eng.opt_state = eng.optimizer.init(eng.params)
        l1 = eng.train_epoch()["loss"]
        v1 = eng.evaluate("val")
        out[family] = dict(loss=(l1, eng.train_epoch()["loss"]), val=v1)
    return out


@pytest.mark.parametrize("family", ["memory", "frozen"])
def test_dp2_state2_matches_the_jax_sharded_engine(dp2, jax_runs, family):
    got = _unpack(dp2[0][0 if family == "memory" else 1])
    want = jax_runs[family]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(got["val_unique"], want["val"], rtol=RTOL)


def test_dp2_checkpoint_resume_continues_the_run(dp2):
    """Saved after epoch 1 at dp = 2, state = 2 by rank 0 alone, loaded by
    every rank into a fresh engine: the val pass, epoch 2 and its val MRR
    equal the uninterrupted run's."""
    rec = dp2[0][0]
    got = _unpack(rec)
    nbytes, (vc, l2, (v2, _)) = rec[1], rec[9:]
    assert nbytes > 0 and all(r[0][1] == 0 for r in dp2[1:])
    assert vc == pytest.approx(got["val_chunked"], rel=CKPT_REL)
    assert l2 == pytest.approx(got["loss"][1], rel=CKPT_REL)
    assert v2 == pytest.approx(got["val2"], rel=CKPT_REL)


def test_dp2_ranks_hold_one_state(dp2):
    """Every rank ends with the same parameters, the same gathered memory
    and the same packer state."""
    for job in range(2):
        ref = _unpack(dp2[0][job])["state"]
        for rank in dp2[1:]:
            st = _unpack(rank[job])["state"]
            _assert_params_equal(st["params"], ref["params"])
            for a, b in zip(st["packer"], ref["packer"]):
                np.testing.assert_array_equal(a, b)
            if ref["mem"] is not None:
                for f in ref["mem"]:
                    assert torch.equal(st["mem"][f], ref["mem"][f]), f


# ------------------------------------------- dp = 1, state = 2: bit-equal
def test_dp1_state2_is_the_serial_engine_bit_for_bit(tmp_path):
    """State sharding changes no arithmetic: at the config's dropout (the
    serial generator at dp = 1) the losses, AP/AUC, MRRs, parameters and
    the gathered MemoryState are the serial Engine's, bit for bit."""
    raw = _raw("memory", dropout=0.2)
    ops = [["epoch"], ["val"], ["test"], ["state"]]
    runs = _run_ranks(tmp_path, 1, 2, [dict(raw=raw, data=DATA, ops=ops)])
    eng = Engine(synthetic(**DATA), parse_config_dict(raw), device="cpu")
    loss = eng.train_epoch()["loss"]
    val, test = eng.evaluate("val"), eng.evaluate("test")
    for rank in runs:
        l, (v, _), (t, _), st = rank[0]
        assert (l, v, t) == (loss, val, test)
        _assert_params_equal(eng.model.state_dict(), st["params"])
        _assert_mem_equal(eng, st["mem"])


# --------------------------------------------------- world size 1 in-process
@pytest.fixture
def group_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("family", ["frozen", "memory", "jodie"])
def test_world_size_one_is_the_serial_engine(group_of_one, family):
    """At the config's dropout: epoch stats, val and test MRR, the
    parameters and the MemoryState, bit for bit."""
    assert group_of_one.shape == {"dp": 1, "state": 1}
    raw = _raw(family, dropout=0.2)
    a = Engine(synthetic(**DATA), parse_config_dict(raw), device="cpu")
    b = ShardedEngine(synthetic(**DATA), parse_config_dict(raw),
                      mesh=group_of_one, device="cpu")
    assert a.train_epoch() == b.train_epoch()
    assert a.evaluate("val") == b.evaluate("val")
    assert a.evaluate("test") == b.evaluate("test")
    _assert_params_equal(a.model.state_dict(), b.model.state_dict())
    if a.use_memory:
        _assert_mem_equal(a, b.full_memory_state()._asdict())


def test_world_size_one_checkpoint_round_trip(group_of_one, tmp_path):
    """The sharded checkpoint holds the serial layout: the serial Engine
    loads it and continues as the sharded engine does."""
    raw = _raw("memory", dropout=0.2)
    a = ShardedEngine(synthetic(**DATA), parse_config_dict(raw),
                      mesh=group_of_one, device="cpu")
    a.train_epoch()
    path = str(tmp_path / "c.pt")
    assert a.save_checkpoint(path) == os.path.getsize(path)
    b = Engine(synthetic(**DATA), parse_config_dict(raw), device="cpu")
    b.load_checkpoint(path)
    assert a.train_epoch() == b.train_epoch()
    _assert_params_equal(a.model.state_dict(), b.model.state_dict())


# ---------------------------------------------------------------- the mesh
@pytest.mark.parametrize("n,dp,state", [(1, None, None), (2, None, None),
                                        (4, None, None), (8, None, None),
                                        (8, 8, 1), (8, None, 4), (8, 2, None),
                                        (4, 2, 2)])
def test_mesh_shape_matches_jax(n, dp, state):
    want = dict(jax_mesh.make_mesh(n, dp=dp, state=state).shape)
    assert mesh_shape(n, dp, state) == want


def test_mesh_refuses_a_shape_that_is_not_the_world():
    with pytest.raises(ValueError, match="world size"):
        make_mesh(2, dp=2, state=1)
    with pytest.raises(ValueError, match="ranks"):
        mesh_shape(8, dp=3, state=2)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("case,raw,dp", [
    ("dyrep", dict(gnn=dict(arch="dyrep")), 1),
    ("layer 2", dict(gnn=dict(layer=2)), 1),
    ("device_cache", dict(train=dict(device_cache=True)), 1),
    ("wire_train_lean", dict(train=dict(wire_train_lean=True)), 1),
    ("batch % dp", dict(train=dict(batch_size=130)), 4),
    ("dp 3", dict(train=dict(batch_size=129)), 3)])
def test_refusals(case, raw, dp):
    """Each raises ValueError before the engine touches the mesh (a
    stand-in with dp is enough)."""
    base = _raw("memory")
    for sec, kv in raw.items():
        base[sec] = [{**base[sec][0], **kv}]
    with pytest.raises(ValueError):
        ShardedEngine(synthetic(**DATA), parse_config_dict(base),
                      mesh=SimpleNamespace(dp=dp, state=1), device="cpu")


# ------------------------------------------------------------------- fit
@pytest.fixture(scope="module")
def fit_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit")
    raw = dict(sampling=[dict(neighbor=[4])],
               memory=[dict(dim_out=8, dim_time=8)],
               gnn=[dict(dim_out=8, att_head=2, dim_time=8)],
               train=[dict(batch_size=128, lr=1e-3, frozen_memory=False)])
    kw = dict(calls=[4], dir="fit", eval_every=1, patience=1,
              checkpoint_every=1, val_snapshot=True)
    # a second job: two fit calls with one monitor, patience 1, and a
    # tolerance no later val pass beats, so the monitor stops at epoch 2
    # whatever the val MRRs are
    twice = dict(calls=[1, 3], dir="fit_twice", patience=1, tolerance=1e9)
    return tmp, _run_ranks(tmp, 2, 1, [dict(raw=raw, data=FIT_DATA,
                                            ops=[["fit", kw]]),
                                       dict(raw=raw, data=FIT_DATA,
                                            ops=[["fit", twice]])])


def test_fit_logs_and_writes_on_rank_zero_alone(fit_run):
    tmp, runs = fit_run
    r0, r1 = runs[0][0][0], runs[1][0][0]
    n = len(r0["hist"]["loss"])
    assert n >= 1 and len(r0["hist"]["val"]) == n and r0["epoch"] == n
    assert r1["lines"] == [] and r0["lines"]
    assert all(l.startswith("[sharded {'dp': 2, 'state': 1}] ")
               for l in r0["lines"])
    assert any("Epoch: 01" in l for l in r0["lines"])
    log = (tmp / "fit" / "metrics.jsonl").read_text()
    events = [json.loads(l)["event"] for l in log.splitlines()]
    assert events.count("train_epoch") == n and events.count("val") == n
    assert (tmp / "fit" / "ckpt_epoch0001.pt").exists()
    assert (tmp / "fit" / "model_best.pt").exists()


def test_fit_takes_one_early_stop_decision_on_every_rank(fit_run):
    """Both ranks stop at one epoch with the same history and restore the
    same best parameters (rank 0 from model_best.pt, rank 1 from
    memory)."""
    _, runs = fit_run
    r0, r1 = runs[0][0][0], runs[1][0][0]
    assert r0["hist"]["loss"] == r1["hist"]["loss"]
    assert r0["hist"]["val"] == r1["hist"]["val"]
    assert r0["epoch"] == r1["epoch"]
    _assert_params_equal(r0["params"], r1["params"])
    best = torch.load(fit_run[0] / "fit" / "model_best.pt",
                      weights_only=True)["params"]
    if r0["epoch"] < 4:          # stopped early: the best was restored
        _assert_params_equal(best, r0["params"])


def test_fit_keeps_the_monitor_across_calls_on_every_rank(fit_run):
    """Two fit calls with one monitor: every rank carries its counters
    from the first call into the second, so both stop at epoch 2 and
    restore epoch 1's parameters (rank 0 from model_best.pt, rank 1 from
    memory)."""
    tmp, runs = fit_run
    r0, r1 = runs[0][1][0], runs[1][1][0]
    for r in (r0, r1):
        assert r["epoch"] == 2
        assert [len(h["loss"]) for h in r["hists"]] == [1, 1]
    for key in ("loss", "val"):
        assert [h[key] for h in r0["hists"]] == [h[key] for h in r1["hists"]]
    assert any("early stopping at epoch 2 (best epoch 1)" in l
               for l in r0["lines"])
    best = torch.load(tmp / "fit_twice" / "model_best.pt",
                      weights_only=True)["params"]
    _assert_params_equal(best, r0["params"])
    _assert_params_equal(best, r1["params"])


def test_fit_eval_every_skips_val_passes():
    eng = _serial("memory", data=FIT_DATA)
    hist = eng.fit(epochs=3, log=lambda s: None, eval_every=2)
    assert len(hist["loss"]) == 3 and len(hist["val"]) == 1


# ------------------------------------------------------------------- CLI
def test_cli_sharded_world_size_one():
    from tgb_tgn_dgl_tpu_torch.run_tgn import main
    out = main(["--data", "tgbl-wiki-small", "--synthetic", "--epochs", "1",
                "--engine", "sharded", "--dp", "1", "--state-ax", "1",
                "--device", "cpu",
                "--config", str(ROOT / "tgb_tgn_dgl_tpu_torch" / "configs"
                                / "TGN.yml")])
    eng = out["engine"]
    assert isinstance(eng, ShardedEngine)
    assert eng.mesh.shape == {"dp": 1, "state": 1}
    assert np.isfinite(out["histories"][0]["loss"][0])
    assert 0.0 < out["histories"][0]["val"][0] <= 1.0


# ------------------------------------------------------------------ card
@pytest.mark.cuda
@pytest.mark.parametrize("family", ["frozen", "memory", "jodie"])
def test_cuda_world_size_one_nccl_is_the_serial_gpu_engine(tmp_path, family):
    """On the card, a NCCL group of one: the sharded engine equals the
    serial GPU engine bit for bit, both under
    torch.use_deterministic_algorithms (the memory path's default CUDA ops
    do not repeat a run bit for bit at this size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    raw = parse_config_dict(_raw(family, dropout=0.2))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = Engine(synthetic(**DATA), raw, device="cuda")
        b = ShardedEngine(synthetic(**DATA), raw,
                          mesh=make_mesh(backend="nccl"), device="cuda")
        assert a.train_epoch() == b.train_epoch()
        assert a.evaluate("val") == b.evaluate("val")
        _assert_params_equal(a.model.state_dict(), b.model.state_dict())
        if a.use_memory:
            _assert_mem_equal(a, b.full_memory_state()._asdict())
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def test_cli_sharded_without_a_gpu_raises():
    """Without --device cpu the sharded CLI takes NCCL on the GPU; with no
    GPU the Engine raises, as the serial CLI's does."""
    from tgb_tgn_dgl_tpu_torch.run_tgn import main
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--data", "tgbl-wiki-small", "--synthetic", "--epochs", "1",
              "--engine", "sharded", "--dp", "1", "--state-ax", "1"])
