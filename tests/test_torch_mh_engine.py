"""The port's MultiHostEngine (tgb_tgn_dgl_tpu_torch/parallel/mh_engine.py)
on the CPU against the JAX package's ``MultiHostEngine`` (``mesh=None``),
in the style of tests/test_mh_engine.py: a 150-node stream of 1,296 train
events, batch 128, D = 16, 2 heads, mailbox 2, dropout 0, 2 hosts, the
same (bridged) initial weights.  An epoch is 5 super-batches of 2 x 128
events and a 16-event tail batch.

  * frozen, memory (TGN), JODIE and DyRep: the epoch's loss, AP and AUC,
    the parameters and the memory state within the engine lockstep's TOL
    (tests/test_torch_engine.py; DyRep's mail as tests/test_torch_archs.py
    holds it), the packer state and its sticky table exactly, then the
    inherited val pass on the exchanged state (MRR within 1e-3);
  * the ragged tail (batch 96: 6 super-batches, tail batches of 96 and
    48) against JAX;
  * the owned exchange bit-equal to the replicated one over two epochs
    and a val pass, for all four families;
  * the packer state after an epoch equal to a serial ``Engine``'s;
  * ``host_only`` (no step) and ``max_super_batches`` (no tail);
  * ``last_epoch_trace``'s fields, for both exchanges;
  * the inherited ``fit``, checkpoint and resume: a run resumed from its
    epoch-1 checkpoint equals the uninterrupted run exactly;
  * ``warm_buckets``: the sticky table equals the JAX Engine's on the
    same stream (host packer, frozen and with the memory; the lean packer
    in device-cache mode; two layers by column chunks), warming twice or
    over a loaded table changes nothing, and ``fit`` warms once;
  * the configurations the engine cannot compose raise ValueError;
  * on the GPU (``cuda``-marked, skipped here): GPU against CPU.
"""
import numpy as np
import pytest
import torch

from test_torch_archs import TE_TOL, _assert_state_match
from test_torch_engine import MRR_TOL, TOL
from tgb_tgn_dgl_tpu.data.dataset import synthetic as jax_synthetic
from tgb_tgn_dgl_tpu.engine.train import Engine as JaxEngine
from tgb_tgn_dgl_tpu.parallel.mh_engine import \
    MultiHostEngine as JaxMultiHostEngine
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.bridge import (eager_memory_state_from_jax,
                                          memory_state_from_jax,
                                          params_from_jax, params_to_jax)
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.parallel.mh_engine import MultiHostEngine
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

FAMILIES = {"frozen": (True, "transformer_attention"),
            "memory": (False, "transformer_attention"),
            "jodie": (False, "identity"),
            "dyrep": (False, "dyrep")}
PACKER = ("cache_nbr", "cache_eid", "cache_t", "clock", "mail_ptr")
TRACE = {"total_s", "pack_s", "disp_s", "stack_s", "exchange_s",
         "replan_s", "host_s", "batches", "super_batches"}


def _raw(family, B=128, **train):
    frozen, arch = FAMILIES[family]
    mem = dict(dim_out=16, dim_time=16, mailbox_size=2)
    if arch == "identity":
        mem["memory_update"] = "rnn"
    return dict(
        sampling=[dict(neighbor=[5])], memory=[mem],
        gnn=[dict(arch=arch, dim_out=16, att_head=2, dim_time=16)],
        train=[dict(batch_size=B, lr=1e-3, dropout=0.0, att_dropout=0.0,
                    frozen_memory=frozen, seed=3, **train)])


def _data(mod):
    return mod("mh-engine", num_edges=1850, num_nodes=150, msg_dim=6,
               num_neg=4, seed=41)


def _engine(family, exchange="replicated", cls=MultiHostEngine, **kw):
    raw = _raw(family, **kw)
    if cls is Engine:
        return Engine(_data(synthetic), parse_config_dict(raw), device="cpu")
    return cls(_data(synthetic), parse_config_dict(raw), n_hosts=2,
               exchange=exchange, device="cpu")


def _jax_engine(family, **kw):
    # the port's eval protocol (slot-unique) on the JAX side too
    return JaxMultiHostEngine(_data(jax_synthetic), jax_config(
        _raw(family, eval_slot_unique=True, **kw)), n_hosts=2)


def _assert_params_close(jparams, model):
    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=path)

    walk(params_to_jax(model.state_dict()), jparams, "")


def _assert_packers_equal(a, b):
    for f in PACKER:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert a.cur_e_id == b.cur_e_id


def _jax_memory(jeng):
    if jeng.eager_memory:
        return eager_memory_state_from_jax(jeng.mem_state)
    return memory_state_from_jax(jeng.mem_state)


def _stats(s):
    return {k: s[k] for k in ("loss", "ap", "auc", "events")}


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("family", list(FAMILIES))
def test_epoch_and_val_match_jax(family):
    jeng = _jax_engine(family)
    peng = _engine(family)
    peng.model.load_state_dict(params_from_jax(jeng.params))
    js, ps = _stats(jeng.train_epoch()), peng.train_epoch()
    assert ps["events"] == js["events"] == 1296
    for k in ("loss", "ap", "auc"):
        np.testing.assert_allclose(ps[k], js[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    _assert_params_close(jeng.params, peng.model)
    if peng.use_memory:
        _assert_state_match(peng.mem_state, _jax_memory(jeng), family)
    _assert_packers_equal(peng.packer, jeng.packer)
    assert peng.packer.bucket_state() == jeng.packer._sticky
    tr = peng.last_epoch_trace
    assert (tr["super_batches"], tr["batches"], peng._step) == (5, 10, 11)
    v_p, v_j = peng.evaluate("val"), jeng.evaluate("val")
    assert peng.last_eval_trace["protocol"] == "slot_unique"
    assert abs(v_p - v_j) <= MRR_TOL and 0.0 < v_p <= 1.0


def test_ragged_tail_matches_jax():
    """Batch 96: 6 super-batches of 2 x 96, then tail batches of 96 and
    48 through the inherited single-device step."""
    jeng = _jax_engine("frozen", B=96)
    peng = _engine("frozen", B=96)
    peng.model.load_state_dict(params_from_jax(jeng.params))
    js, ps = _stats(jeng.train_epoch()), peng.train_epoch()
    assert ps["events"] == js["events"] == int(np.sum(peng.data.train_mask))
    np.testing.assert_allclose(ps["loss"], js["loss"], rtol=TOL, atol=TOL)
    _assert_params_close(jeng.params, peng.model)
    _assert_packers_equal(peng.packer, jeng.packer)
    tr = peng.last_epoch_trace
    assert (tr["super_batches"], tr["batches"], peng._step) == (6, 13, 14)


# ---------------------------------------------------- the port on its own
@pytest.mark.parametrize("family", list(FAMILIES))
def test_owned_exchange_equals_replicated(family):
    rep, own = _engine(family), _engine(family, "owned")
    for _ in range(2):
        assert own.train_epoch() == rep.train_epoch()
    for a, b in zip(rep.model.parameters(), own.model.parameters()):
        assert torch.equal(a, b)
    if rep.use_memory:
        for a, b in zip(rep.mem_state, own.mem_state):
            assert torch.equal(a, b)
    _assert_packers_equal(own.packer, rep.packer)
    assert own.evaluate("val") == rep.evaluate("val")
    _assert_packers_equal(own.packer, rep.packer)


def test_packer_state_equals_a_serial_engine():
    mh, serial = _engine("memory"), _engine("memory", cls=Engine)
    mh.train_epoch()
    serial.train_epoch()
    _assert_packers_equal(mh.packer, serial.packer)


def test_host_only_and_max_super_batches():
    """host_only: the host path of 3 super-batches, no step, no tail;
    max_super_batches alone: 2 composed steps, no tail."""
    eng = _engine("memory")
    before = [p.detach().clone() for p in eng.model.parameters()]
    stats = eng.train_epoch(host_only=True, max_super_batches=3)
    tr = eng.last_epoch_trace
    assert stats["events"] == 3 * 256 and eng._step == 0
    assert not eng.optimizer.state
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                   eng.model.parameters()))
    assert (tr["super_batches"], tr["batches"], tr["disp_s"]) == (3, 6, 0.0)
    for k in ("pack_s", "exchange_s", "replan_s", "stack_s", "host_s"):
        assert tr[k] > 0.0, k
    eng = _engine("memory")
    stats = eng.train_epoch(max_super_batches=2)
    tr = eng.last_epoch_trace
    assert stats["events"] == 512 and eng._step == 4
    assert (tr["super_batches"], tr["batches"]) == (2, 4)
    assert tr["disp_s"] > 0.0


@pytest.mark.parametrize("exchange", ["replicated", "owned"])
def test_epoch_trace_fields(exchange):
    eng = _engine("memory", exchange)
    eng.train_epoch()
    tr = eng.last_epoch_trace
    assert set(tr) == TRACE
    for k in TRACE - {"batches", "super_batches"}:
        assert tr[k] > 0.0, k
    assert tr["total_s"] >= tr["pack_s"] + tr["exchange_s"] + tr["disp_s"]
    shared = tr["exchange_s"] + tr["replan_s"] + tr["stack_s"]
    assert shared < tr["host_s"] <= shared + tr["pack_s"]


def test_fit_resumes_exactly(tmp_path):
    """The inherited fit, checkpoint and resume on the owned exchange: a
    run resumed from its epoch-1 checkpoint gives epoch 2's loss and val
    MRR of the uninterrupted run, exactly."""
    whole = _engine("memory", "owned")
    hw = whole.fit(epochs=2, log=lambda s: None, checkpoint_dir=str(tmp_path),
                   checkpoint_every=1, log_dir=str(tmp_path))
    assert len(hw["loss"]) == len(hw["val"]) == 2 and whole._epoch == 2
    resumed = _engine("memory", "owned")
    resumed.load_checkpoint(str(tmp_path / "ckpt_epoch0001.pt"))
    hr = resumed.fit(epochs=1, log=lambda s: None)
    assert hr["loss"] == hw["loss"][1:] and hr["val"] == hw["val"][1:]
    _assert_packers_equal(resumed.packer, whole.packer)


# ------------------------------------------------------------ warm_buckets
WARM_CASES = {"frozen": dict(family="frozen"),
              "memory": dict(family="memory"),
              "device_cache": dict(family="frozen", device_cache=True),
              "layer2": dict(family="memory", layer=2, eval_neg_chunk=3)}


def _warm_raw(family, layer=1, **train):
    raw = _raw(family, **train)
    return dict(raw, gnn=[dict(raw["gnn"][0], layer=layer)])


@pytest.mark.parametrize("case", list(WARM_CASES))
def test_warm_buckets_table_matches_jax(case):
    """The sticky table after warm_buckets equals the JAX Engine's, the
    eval profile under each side's protocol (slot-unique, column chunks
    at two layers and in device-cache mode)."""
    kw = dict(WARM_CASES[case])
    family = kw.pop("family")
    peng = Engine(_data(synthetic), parse_config_dict(_warm_raw(family,
                                                                **kw)),
                  device="cpu")
    jeng = JaxEngine(_data(jax_synthetic), jax_config(
        _warm_raw(family, eval_slot_unique=True, **kw)))
    assert peng.device_cache == (case == "device_cache")
    peng.warm_buckets()
    jeng.warm_buckets()
    table = peng.packer.bucket_state()
    assert table == jeng.packer._sticky
    assert any(k[1] for k in table) and any(not k[1] for k in table)
    peng.warm_buckets()
    assert peng.packer.bucket_state() == table


def test_warming_keeps_a_larger_table_and_fit_warms_once():
    eng = _engine("memory", cls=Engine)
    eng.warm_buckets()
    table = eng.packer.bucket_state()
    larger = {k: {n: 2 * v for n, v in names.items()}
              for k, names in table.items()}
    eng.packer.load_bucket_state(larger)
    eng.warm_buckets()
    assert eng.packer.bucket_state() == larger
    fresh, calls = _engine("memory", cls=Engine), []
    warm = fresh.warm_buckets

    def spy():
        calls.append(1)
        warm()

    fresh.warm_buckets = spy
    fresh.fit(epochs=0, log=lambda s: None)
    fresh.fit(epochs=0, log=lambda s: None)
    assert calls == [1] and fresh._warmed


# ------------------------------------------------------- refused settings
@pytest.mark.parametrize("bad", ["layer2", "device_cache", "no_intra_cap",
                                 "exchange", "hosts"])
def test_refuses_what_it_cannot_compose(bad):
    raw = _warm_raw("frozen", layer=2 if bad == "layer2" else 1,
                    **({"device_cache": True} if bad == "device_cache"
                       else {}))
    cfg = parse_config_dict(raw)
    if bad == "no_intra_cap":
        cfg.train.max_intra_block = None
    with pytest.raises(ValueError):
        MultiHostEngine(_data(synthetic), cfg,
                        n_hosts=0 if bad == "hosts" else 2,
                        exchange="nope" if bad == "exchange" else "owned",
                        device="cpu")


# --------------------------------------------------------------- the GPU
@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cuda_multihost_matches_cpu(family):
    """The GPU engine (the attention kernels) against the CPU engine from
    the same seed: the epoch's loss, the parameters and the memory state
    within TOL, the packer state exactly.  Then the owned exchange on the
    card bit-equal to the replicated one, both under
    torch.use_deterministic_algorithms: at this size the memory path's
    default CUDA ops do not repeat a run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    raw = parse_config_dict(_raw(family))
    runs = {}
    for dev, exchange, det in (("cpu", "replicated", False),
                               ("cuda", "replicated", False),
                               ("cuda", "replicated", True),
                               ("cuda", "owned", True)):
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            eng = MultiHostEngine(_data(synthetic), raw, n_hosts=2,
                                  exchange=exchange, device=dev)
            runs[dev, exchange, det] = (eng, eng.train_epoch())
        finally:
            torch.use_deterministic_algorithms(False)
    (cpu, sc), (gpu, sg), (rep, sr), (own, so) = runs.values()
    np.testing.assert_allclose(sg["loss"], sc["loss"], rtol=TOL, atol=TOL)
    for a, b in zip(gpu.model.parameters(), cpu.model.parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), rtol=TOL, atol=TOL)
    if gpu.use_memory:
        _assert_state_match(type(gpu.mem_state)(*(t.cpu() for t in
                                                  gpu.mem_state)),
                            cpu.mem_state, family, te_tol=TE_TOL)
    _assert_packers_equal(gpu.packer, cpu.packer)
    assert so == sr
    for a, b in zip(own.model.parameters(), rep.model.parameters()):
        assert torch.equal(a, b)
    if own.use_memory:
        for a, b in zip(own.mem_state, rep.mem_state):
            assert torch.equal(a, b)
