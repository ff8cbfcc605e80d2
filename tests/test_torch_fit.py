"""The port's training entry point (tgb_tgn_dgl_tpu_torch/engine/train.py
``Engine.fit``, the full-state checkpoint, ``snapshot_stream`` /
``restore_stream``; engine/checkpoint.py; utils/metrics.py) on the CPU,
on a tiny stream (1,000 events, 100 nodes, D = 8, 2 heads, batch 100):

  * ``fit(epochs=2)`` against the JAX ``fit(epochs=2)`` from bridged
    weights at dropout 0, frozen and with the memory: ``history["loss"]``
    (Σ loss·n an epoch) and ``history["val"]`` within the engine
    lockstep's TOL (1e-4 abs+rel), the same keys, and the same log lines
    once their numbers are masked;
  * a run interrupted after 2 epochs and resumed from its checkpoint for
    1 equals an uninterrupted 3-epoch run exactly — parameters, Adam's
    state, ``mem_state``, the packer's state, the negative sampler, the
    cursors and the epoch-3 history — for TGN frozen, with the memory, at
    two layers, JODIE and DyRep, at dropout 0.1 (so the dropout
    generator's state is part of what must resume);
  * ``val_snapshot`` keeps validation out of the training trajectory (the
    JAX tests/test_engine.py ``test_val_snapshot_protects_training``,
    host-pack case), and a snapshot stays valid after a restore;
  * ``EarlyStopMonitor`` gives the JAX monitor's decisions and
    ``best_epoch``; early stopping in ``fit`` restores the best epoch's
    parameters;
  * the PCG64 state round-trips (the JAX serialization, then through a
    checkpoint); a checkpoint with a missing key or a wrong shape raises
    and names the key; a generator state from another device type raises;
  * ``fit(log_dir=…)`` writes ``train_epoch``, ``val`` and ``checkpoint``
    events; ``fit(epochs=0)`` trains none (the JAX ``fit`` trains the
    config's count there) and ``fit()`` the config's count;
  * on the GPU (``cuda``-marked, skipped here): a resumed run against the
    uninterrupted one within loss rel 1e-3 and MRR abs 1e-3.
"""
import copy
import json
import re

import numpy as np
import pytest
import torch

from test_torch_engine import TOL

from tgb_tgn_dgl_tpu.data.dataset import synthetic as jax_synthetic
from tgb_tgn_dgl_tpu.engine import checkpoint as jax_ckpt
from tgb_tgn_dgl_tpu.engine.train import Engine as JaxEngine
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.bridge import params_from_jax
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.engine import checkpoint as ckpt
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

RAW = dict(
    sampling=[dict(neighbor=[5])],
    gnn=[dict(att_head=2, dim_out=8, dim_time=8)],
    train=[dict(epoch=2, batch_size=100, lr=1e-3, dropout=0.0,
                att_dropout=0.0)],
)


def _data(mod=synthetic):
    return mod("tiny", num_edges=1000, num_nodes=100, msg_dim=4, num_neg=8,
               seed=1)


def _raw(memory=False, dropout=0.0, arch=None, layer=1, rnn=False):
    train = dict(RAW["train"][0], dropout=dropout, att_dropout=dropout,
                 frozen_memory=not memory)
    raw = dict(RAW, train=[train])
    if memory:
        raw["memory"] = [dict(dim_out=8, dim_time=8,
                              memory_update="rnn" if rnn else "gru",
                              use_dst_emb_in_msg=arch == "dyrep")]
    if arch or layer != 1:
        raw["gnn"] = [dict(RAW["gnn"][0], arch=arch or
                           "transformer_attention", layer=layer)]
    return raw


# the resume cases: keyword arguments of ``_raw``
RESUME = {"frozen": {}, "memory": dict(memory=True),
          "tgn_2layer": dict(memory=True, layer=2),
          "jodie": dict(memory=True, arch="identity", rnn=True),
          "dyrep": dict(memory=True, arch="dyrep", rnn=True)}


def _engine(raw, device="cpu"):
    return Engine(_data(), parse_config_dict(raw), device=device)


def _mask_numbers(lines):
    return [re.sub(r"-?\d+(\.\d+)?", "#", line) for line in lines]


# -------------------------------------------------- fit against JAX fit
@pytest.mark.parametrize("memory", [False, True], ids=["frozen", "memory"])
def test_fit_matches_jax(memory):
    raw = _raw(memory=memory)
    jraw = dict(raw, train=[dict(raw["train"][0], fuse_steps=1,
                                 eval_slot_unique=True)])
    jeng = JaxEngine(_data(jax_synthetic), jax_config(jraw))
    peng = _engine(raw)
    peng.model.load_state_dict(params_from_jax(jeng.params))
    jlog, plog = [], []
    jh = jeng.fit(epochs=2, log=jlog.append)
    ph = peng.fit(epochs=2, log=plog.append)
    assert ph.keys() == jh.keys()
    assert len(ph["loss"]) == len(ph["val"]) == 2
    np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ph["val"], jh["val"], rtol=TOL, atol=TOL)
    assert _mask_numbers(plog) == _mask_numbers(jlog)
    assert plog[0].startswith("Epoch: 01, Loss: ")
    assert peng._epoch == jeng._epoch == 2 and peng._step == jeng._step


# ---------------------------------------------------------- exact resume
def _full_state_copy(eng):
    return copy.deepcopy(eng._full_state())


def _assert_trees_equal(a, b, path=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _record_shapes(engine, out):
    """The shapes of every device pack the engine expands, in order."""
    expand = engine._expand

    def wrapped(wire, iw):
        pack = expand(wire, iw)
        out.append(tuple(tuple(t.shape) for t in pack if t is not None))
        return pack

    engine._expand = wrapped


@pytest.mark.parametrize("name", sorted(RESUME))
def test_resume_equals_uninterrupted(name, tmp_path):
    """… and pads every batch of epoch 3 to the same shapes (the packer's
    sticky buckets are part of the checkpoint: on the GPU a GEMM's
    summation order follows its shape)."""
    raw = _raw(dropout=0.1, **RESUME[name])
    whole = _engine(raw)
    log, shapes_w, shapes_r = [], [], []
    _record_shapes(whole, shapes_w)
    hw = whole.fit(epochs=3, log=log.append, checkpoint_dir=str(tmp_path),
                   checkpoint_every=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_epoch0001.pt", "ckpt_epoch0002.pt", "ckpt_epoch0003.pt"]
    resumed = _engine(raw)
    resumed.load_checkpoint(str(tmp_path / "ckpt_epoch0002.pt"))
    assert (resumed._epoch, resumed._step) == (2, 2 * 7)
    saved = torch.load(tmp_path / "ckpt_epoch0002.pt", weights_only=True)
    assert resumed.packer.bucket_state() == saved["packer"]["buckets"]
    assert {(1, False), (8, True)} <= set(saved["packer"]["buckets"])
    _record_shapes(resumed, shapes_r)
    rlog = []
    hr = resumed.fit(epochs=1, log=rlog.append)
    assert shapes_r == shapes_w[-len(shapes_r):]
    assert rlog[0].startswith("Epoch: 03, ")
    assert hr["loss"] == hw["loss"][2:] and hr["val"] == hw["val"][2:]
    assert (resumed._epoch, resumed._step) == (3, 3 * 7)
    _assert_trees_equal(_full_state_copy(resumed), _full_state_copy(whole))
    if resumed.use_memory:
        assert resumed.mem_state.mem.abs().max() > 0


def test_resume_in_fit_continues_labels_and_checkpoint_names(tmp_path):
    """A resumed ``fit`` names its checkpoints from the cursor on."""
    eng = _engine(_raw(memory=True))
    eng.fit(epochs=1, log=lambda s: None, checkpoint_dir=str(tmp_path / "a"),
            checkpoint_every=1)
    again = _engine(_raw(memory=True))
    again.load_checkpoint(str(tmp_path / "a" / "ckpt_epoch0001.pt"))
    again.fit(epochs=2, log=lambda s: None,
              checkpoint_dir=str(tmp_path / "b"), checkpoint_every=2)
    assert [p.name for p in (tmp_path / "b").iterdir()] == [
        "ckpt_epoch0002.pt"]


# --------------------------------------------------------- val snapshots
def _clock(eng):
    return eng.packer.snapshot()[3]


def test_val_snapshot_protects_training():
    """With a snapshot around each val pass, epoch 2 starts from the
    stream state of a run that never validated and gives its loss;
    without it, the streaming eval advances the clocks (the reference
    protocol)."""
    raw = _raw(memory=True)

    def run(val_snapshot):
        eng = _engine(raw)
        clocks = []
        train = eng.train_epoch

        def spy():
            clocks.append(_clock(eng))
            return train()

        eng.train_epoch = spy
        h = eng.fit(epochs=2, log=lambda s: None, val_snapshot=val_snapshot)
        return h, clocks

    eng = _engine(raw)                     # no validation at all
    base = [eng.train_epoch()["loss"]]
    base_clock = _clock(eng)
    base.append(eng.train_epoch()["loss"])
    protected, prot_clocks = run(True)
    unprotected, unprot_clocks = run(False)
    assert len(protected["val"]) == len(unprotected["val"]) == 2
    assert protected["loss"] == base
    np.testing.assert_array_equal(prot_clocks[1], base_clock)
    assert unprotected["loss"][0] == base[0]
    assert not np.array_equal(unprot_clocks[1], base_clock)


def test_snapshot_stays_valid_after_restore():
    """Restoring one snapshot twice gives back the whole state each time,
    but for the packer's shape buckets, which the val pass grows and a
    snapshot leaves alone (they pad, they hold no stream state)."""
    def state(eng):
        st = _full_state_copy(eng)
        del st["packer"]["buckets"]
        return st

    eng = _engine(_raw(memory=True))
    eng.train_epoch()
    snap = eng.snapshot_stream()
    want = state(eng)
    for _ in range(2):
        eng.evaluate("val")
        eng.restore_stream(snap)
        _assert_trees_equal(state(eng), want)


# -------------------------------------------------------- early stopping
SEQUENCES = [[0.5, 0.6, 0.6, 0.55, 0.7, 0.69, 0.68, 0.68],
             [0.3, 0.2, 0.1, 0.1, 0.4], [0.0, 0.0, 1e-12, 0.5, 0.4],
             [-1.0, -0.5, -0.5 + 1e-12, -0.7]]


@pytest.mark.parametrize("higher_better", [True, False])
@pytest.mark.parametrize("max_round", [1, 2, 3])
def test_early_stop_monitor_matches_jax(higher_better, max_round):
    for seq in SEQUENCES:
        mine = ckpt.EarlyStopMonitor(max_round, higher_better)
        ref = jax_ckpt.EarlyStopMonitor(max_round, higher_better)
        for v in seq:
            assert mine.step_check(v) == ref.step_check(v), seq
            assert (mine.best_epoch, mine.num_round, mine.last_best) == (
                ref.best_epoch, ref.num_round, ref.last_best), seq


def test_early_stop_load_best(tmp_path):
    mon = ckpt.EarlyStopMonitor(max_round=2, save_dir=str(tmp_path))
    assert mon.best_path == str(tmp_path / "model_best.pt")
    states = [{"params": {"w": torch.full((3,), float(i))}}
              for i in range(4)]
    stops = [mon.step_check(v, s) for v, s in zip([0.1, 0.3, 0.2, 0.25],
                                                  states)]
    assert stops == [False, False, False, True] and mon.best_epoch == 2
    best = mon.load_best({"params": {"w": torch.zeros(3)}})
    assert torch.equal(best["params"]["w"], states[1]["params"]["w"])


def test_fit_early_stop_restores_the_best_parameters(tmp_path):
    eng = _engine(_raw(memory=True))
    after = []
    train = eng.train_epoch

    def spy():
        out = train()
        after.append(copy.deepcopy(eng.model.state_dict()))
        return out

    vals = iter([0.5, 0.4, 0.3, 0.9])
    eng.train_epoch = spy
    eng.evaluate = lambda split: next(vals)
    log = []
    mon = ckpt.EarlyStopMonitor(max_round=2, save_dir=str(tmp_path))
    h = eng.fit(epochs=4, log=log.append, early_stop=mon)
    assert h["val"] == [0.5, 0.4, 0.3] and len(after) == 3
    assert "INFO: early stopping at epoch 3 (best epoch 1)" in log
    _assert_trees_equal(eng.model.state_dict(), after[0])
    assert any(not torch.equal(after[0][k], after[2][k]) for k in after[0])


# ------------------------------------------------------------ checkpoint
def test_pcg64_round_trip(tmp_path):
    rng = np.random.default_rng(7)
    rng.integers(0, 100, 13)
    state = rng.bit_generator.state
    state.update(has_uint32=1, uinteger=123456789)    # a cached uint32
    rng.bit_generator.state = state
    arr = ckpt.rng_state_to_array(rng)
    assert arr[4] == 1 and arr[5] == 123456789
    np.testing.assert_array_equal(arr, jax_ckpt.rng_state_to_array(rng))
    back = ckpt.rng_state_from_array(arr)
    assert back.bit_generator.state == rng.bit_generator.state
    # through the engine's checkpoint
    eng = _engine(_raw())
    eng.neg_sampler.rng = ckpt.rng_state_from_array(arr)
    path = tmp_path / "c.pt"
    eng.save_checkpoint(str(path))
    other = _engine(_raw())
    other.load_checkpoint(str(path))
    assert other.neg_sampler.rng.bit_generator.state == \
        rng.bit_generator.state
    np.testing.assert_array_equal(other.neg_sampler.rng.integers(0, 99, 50),
                                  rng.integers(0, 99, 50))


def test_checkpoint_holds_only_plain_leaves(tmp_path):
    """Every leaf loads under ``weights_only``: tensors, ints, floats,
    strings, and the lists/tuples/None/bools of Adam's param_groups."""
    eng = _engine(_raw(memory=True))
    eng.fit(epochs=1, log=lambda s: None)
    path = tmp_path / "c.pt"
    eng.save_checkpoint(str(path))
    st = torch.load(path, weights_only=True)
    assert st["epoch"] == 1 and st["step"] == 7
    assert st["generator_device"] == "cpu"
    assert st["neg_rng"].dtype == torch.int64 and st["neg_rng"].shape == (6,)
    assert set(st["packer"]) == {"cache_nbr", "cache_eid", "cache_t",
                                 "clock", "cur_e_id", "mail_ptr", "buckets"}
    assert st["packer"]["buckets"] == eng.packer.bucket_state()
    assert {(1, False), (8, True)} <= set(st["packer"]["buckets"])
    assert set(st["mem_state"]) == set(eng.mem_state._fields)
    n = len(list(eng.model.parameters()))
    assert sorted(st["optimizer"]["state"]) == list(range(n))


def test_fresh_optimizer_state_resumes_as_a_fresh_one(tmp_path):
    """A checkpoint written before any step holds Adam's zero moments; an
    engine loaded from it trains exactly as a fresh one."""
    path = tmp_path / "c.pt"
    _engine(_raw()).save_checkpoint(str(path))
    loaded = _engine(_raw())
    loaded.load_checkpoint(str(path))
    fresh = _engine(_raw())
    assert loaded.train_epoch() == fresh.train_epoch()
    _assert_trees_equal(_full_state_copy(loaded), _full_state_copy(fresh))


def _edit_checkpoint(path, edit):
    st = torch.load(path, weights_only=True)
    edit(st)
    torch.save(st, path)


@pytest.mark.parametrize("key,edit,err", [
    ("packer/clock", lambda st: st["packer"].pop("clock"), KeyError),
    ("mem_state/mem", lambda st: st["mem_state"].pop("mem"), KeyError),
    ("epoch", lambda st: st.pop("epoch"), KeyError),
    ("optimizer/state/0/exp_avg",
     lambda st: st["optimizer"]["state"][0].pop("exp_avg"), KeyError),
    ("packer/cache_nbr", lambda st: st["packer"].__setitem__(
        "cache_nbr", st["packer"]["cache_nbr"][:, :3]), ValueError),
    ("mem_state/mem", lambda st: st["mem_state"].__setitem__(
        "mem", torch.zeros(3, 8)), ValueError)],
    ids=["packer", "mem_state", "epoch", "adam", "packer_shape",
         "mem_shape"])
def test_checkpoint_missing_key_or_wrong_shape_raises(tmp_path, key, edit,
                                                      err):
    eng = _engine(_raw(memory=True))
    path = tmp_path / "c.pt"
    eng.save_checkpoint(str(path))
    _edit_checkpoint(path, edit)
    with pytest.raises(err, match=re.escape(f"'{key}'")):
        _engine(_raw(memory=True)).load_checkpoint(str(path))


def test_generator_from_another_device_raises(tmp_path):
    """A CUDA generator state (Philox seed and offset, 16 bytes) in a CPU
    engine's checkpoint: no fallback, a ValueError naming both types."""
    path = tmp_path / "c.pt"
    _engine(_raw()).save_checkpoint(str(path))

    def as_cuda(st):
        st["generator_device"] = "cuda"
        st["generator"] = torch.zeros(16, dtype=torch.uint8)

    _edit_checkpoint(path, as_cuda)
    with pytest.raises(ValueError, match="cuda.*cpu"):
        _engine(_raw()).load_checkpoint(str(path))


# ------------------------------------------------------- metrics, counts
def test_fit_writes_metrics_events(tmp_path):
    eng = _engine(_raw(memory=True))
    eng.fit(epochs=2, log=lambda s: None, log_dir=str(tmp_path),
            checkpoint_dir=str(tmp_path), checkpoint_every=2)
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["event"] for r in recs] == ["train_epoch", "val",
                                          "train_epoch", "val",
                                          "checkpoint"]
    for r in recs:
        assert r["wall_s"] >= 0
    assert [r["epoch"] for r in recs] == [1, 1, 2, 2, 2]
    tr = recs[0]
    assert set(tr) == {"event", "wall_s", "epoch", "loss", "ap", "auc",
                       "events", "seconds", "events_per_s"}
    assert tr["events"] == 700
    assert recs[1]["metric"] == "mrr" and 0 < recs[1]["value"] <= 1
    assert recs[4]["bytes"] == (tmp_path / "ckpt_epoch0002.pt").stat().st_size


def test_fit_epochs_zero_trains_none_and_none_means_the_config():
    """The port's ``fit(epochs=0)`` trains no epoch; the JAX ``fit`` reads
    0 as "the config's count" (tgb_tgn_dgl_tpu engine/train.py:2026), so
    run_tgn.py's resume with nothing left trains ``train.epoch`` more."""
    eng = _engine(_raw())
    h = eng.fit(epochs=0, log=lambda s: None)
    assert h["loss"] == [] and eng._epoch == 0 and eng._step == 0
    h = eng.fit(log=lambda s: None)
    assert len(h["loss"]) == 2 and eng._epoch == 2
    raw = _raw()
    jraw = dict(raw, train=[dict(raw["train"][0], epoch=1, fuse_steps=1)])
    jeng = JaxEngine(_data(jax_synthetic), jax_config(jraw))
    assert len(jeng.fit(epochs=0, log=lambda s: None)["loss"]) == 1


def test_early_checkpoint_loads_into_an_engine_that_has_evaluated(
        tmp_path):
    """A checkpoint written before any val pass lacks the eval bucket
    keys that an engine which has evaluated holds: it loads all the same,
    its buckets replace the engine's, and the engine then trains and
    validates exactly as the run that wrote it."""
    raw = _raw(memory=True)
    writer = _engine(raw)
    writer.train_epoch()
    path = tmp_path / "c.pt"
    writer.save_checkpoint(str(path))
    assert all(not eval_mode for _, eval_mode in
               writer.packer.bucket_state())
    loader = _engine(raw)
    loader.evaluate("val")
    assert any(eval_mode for _, eval_mode in loader.packer.bucket_state())
    loader.load_checkpoint(str(path))
    assert loader.packer.bucket_state() == writer.packer.bucket_state()
    hw = writer.fit(epochs=1, log=lambda s: None)
    hl = loader.fit(epochs=1, log=lambda s: None)
    assert hl == {**hw, "train_s": hl["train_s"], "val_s": hl["val_s"]}
    _assert_trees_equal(_full_state_copy(loader), _full_state_copy(writer))


# ------------------------------------------------------------------- GPU
@pytest.mark.cuda
def test_cuda_resume_matches_uninterrupted(tmp_path):
    """On the GPU (the attention kernels), with the memory at dropout 0.1:
    a run resumed from its epoch-1 checkpoint gives the uninterrupted
    run's epoch-2 loss and val MRR exactly (the train step adds with no
    atomics, and the checkpoint keeps the padded shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    raw = _raw(memory=True, dropout=0.1)
    whole = _engine(raw, "cuda")
    hw = whole.fit(epochs=2, log=lambda s: None, val_snapshot=True,
                   checkpoint_dir=str(tmp_path), checkpoint_every=1)
    resumed = _engine(raw, "cuda")
    resumed.load_checkpoint(str(tmp_path / "ckpt_epoch0001.pt"))
    hr = resumed.fit(epochs=1, log=lambda s: None, val_snapshot=True)
    assert hr["loss"] == hw["loss"][1:] and hr["val"] == hw["val"][1:]
    with pytest.raises(ValueError, match="cuda.*cpu|cpu.*cuda"):
        _engine(raw).load_checkpoint(str(tmp_path / "ckpt_epoch0001.pt"))
