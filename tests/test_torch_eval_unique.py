"""The port's slot-unique eval (engine/train.py::_evaluate_unique and its
gate) against the port's column-chunk protocol (``_evaluate_chunked``)
and against the JAX Engine, on the CPU, at the sizes of
tests/test_eval_unique.py: batch 150, 2 heads, dim 16, K = 5, 7
negatives, dropout 0.

  * slot-unique against column chunks, frozen and with the mailbox
    memory: val then test give the same metric, and leave the same packer
    state and ``MemoryState``, exactly (the same embeddings, the same
    predictor math, integer rank counts);
  * slot-unique against the JAX ``_evaluate_unique`` after one lockstep
    train epoch from bridged weights: metric within 1e-3 (a rank can flip
    on a near-tie), ``mem`` within 1e-4, the rest of the state exact;
  * several embed chunks, more than 255 dependency blocks (u16 block ids),
    the gate and its log, a batch the packer hands back;
  * the gate opens whatever the dedup, where the JAX "auto" estimate
    closes the JAX Engine's, and a config naming the JAX knob
    ``eval_slot_unique`` is refused;
  * a ragged stream (each row's negatives cut to a seeded length in
    1..M): pad_mask and truncate_min, MRR and hits@10, val then test,
    against the JAX Engine under both protocols.  That stream has 24
    negatives, so that hits@10 is not 1 by construction;
  * in pad+mask mode each chunk's negative mask crosses in its wire's
    staging buffer and copy (``wire_to_device``).
"""
import dataclasses

import numpy as np
import pytest

from tgb_tgn_dgl_tpu.data.dataset import synthetic as jax_synthetic
from tgb_tgn_dgl_tpu.engine.train import Engine as JaxEngine
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.bridge import memory_state_from_jax, params_from_jax
from tgb_tgn_dgl_tpu_torch.data import dataset as port_dataset
from tgb_tgn_dgl_tpu_torch.engine import train as port_train
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.ops.wire import wire_to_device
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

MRR_TOL = 1e-3
MEM_TOL = 1e-4


def _raw(frozen=True, neg_mode="truncate_min", **train):
    return {
        "sampling": [{"neighbor": [5]}],
        "memory": [{"dim_out": 16, "dim_time": 16, "mailbox_size": 2}],
        "gnn": [{"dim_out": 16, "att_head": 2, "dim_time": 16}],
        "train": [dict(dict(batch_size=150, lr=1e-3, dropout=0.0,
                            att_dropout=0.0, frozen_memory=frozen,
                            eval_neg_mode=neg_mode, seed=11), **train)],
    }


def _port(data, raw):
    return Engine(data, parse_config_dict(raw), device="cpu")


def _data(synthetic=port_dataset.synthetic, num_neg=7):
    return synthetic("eval-unique", num_edges=1400, num_nodes=120,
                     msg_dim=6, num_neg=num_neg, seed=19)


def _assert_packers_equal(a, b):
    for x, y in zip(a.packer.snapshot(), b.packer.snapshot()):
        np.testing.assert_array_equal(x, y)


def _assert_mem_equal(a, b):
    for f in a.mem_state._fields:
        np.testing.assert_array_equal(getattr(a.mem_state, f).numpy(),
                                      getattr(b.mem_state, f).numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "memory"])
def test_unique_matches_column_chunk(frozen):
    """Val then test: the same metric, packer state and MemoryState as the
    column-chunk protocol (in chunks of 3 negatives), exactly."""
    data = _data()
    a = _port(data, _raw(frozen, eval_neg_chunk=3))
    b = _port(data, _raw(frozen, eval_neg_chunk=3))
    for eng in (a, b):
        eng.train_epoch()
    for split in ("val", "test"):
        ma, mb = a._evaluate_chunked(split), b.evaluate(split)
        assert a.last_eval_trace["protocol"] == "column_chunk"
        assert b.last_eval_trace["protocol"] == "slot_unique"
        assert 0.0 < mb <= 1.0 and ma == mb, (split, ma, mb)
        _assert_packers_equal(a, b)
        if not frozen:
            _assert_mem_equal(a, b)
    tr = b.last_eval_trace
    assert tr["batches"] == tr["embed_chunks"] == tr["chunks"] == 2
    assert a.last_eval_trace["chunks"] == 2 * 3        # ceil(7 / 3) a batch


def _jax_and_port(data_jax, data_port, raw):
    """Both engines from the same (bridged) weights after one train epoch
    in lockstep; the JAX Engine's slot-unique gate forced open."""
    jraw = dict(raw, train=[dict(raw["train"][0], fuse_steps=1,
                                 eval_slot_unique=True)])
    jeng = JaxEngine(data_jax, jax_config(jraw))
    peng = _port(data_port, raw)
    peng.model.load_state_dict(params_from_jax(jeng.params))
    jeng.train_epoch()
    peng.train_epoch()
    return jeng, peng


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "memory"])
def test_unique_matches_jax_evaluate_unique(frozen):
    jeng, peng = _jax_and_port(_data(jax_synthetic), _data(), _raw(frozen))
    calls = []
    run = jeng._evaluate_unique

    def spy(*args):
        calls.append(args[0])
        return run(*args)

    jeng._evaluate_unique = spy
    for split in ("val", "test"):
        jm, pm = jeng.evaluate(split), peng.evaluate(split)
        assert peng.last_eval_trace["protocol"] == "slot_unique"
        assert abs(pm - jm) <= MRR_TOL, (split, pm, jm)
        _assert_packers_equal(peng, jeng)
        if not frozen:
            want = memory_state_from_jax(jeng.mem_state)
            for f in want._fields:
                a, b = getattr(peng.mem_state, f).numpy(), \
                    getattr(want, f).numpy()
                assert a.dtype == b.dtype, f
                if f == "mem":
                    np.testing.assert_allclose(a, b, rtol=MEM_TOL,
                                               atol=MEM_TOL, err_msg=f)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f)
    assert calls == ["val", "test"]


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "memory"])
def test_several_embed_chunks_match_one(frozen, monkeypatch):
    """A budget of 256 root slots splits each batch's table into several
    embed chunks; the result equals one chunk's, exactly."""
    data = _data()
    one = _port(data, _raw(frozen))
    one.train_epoch()
    want = [one.evaluate("val"), one.evaluate("test")]
    assert one.last_eval_trace["embed_chunks"] == 2
    many = _port(data, _raw(frozen))
    many.train_epoch()
    monkeypatch.setattr(port_train, "EVAL_UNIQUE_SLOTS", 256)
    got = [many.evaluate("val"), many.evaluate("test")]
    assert many.last_eval_trace["embed_chunks"] > 2 * 2
    assert got == want
    _assert_packers_equal(one, many)
    if not frozen:
        _assert_mem_equal(one, many)


def _hub_data(M=5, seed=3):
    """The port's copy of tests/test_eval_unique.py::_hub_data: a hub is
    the source of 350 of the 600 val events, so the leveler chains them
    into about 350 blocks of one batch."""
    rng = np.random.default_rng(seed)
    E, N = 1800, 80
    src = rng.integers(1, N // 2, size=E).astype(np.int32)
    dst = rng.integers(N // 2, N, size=E).astype(np.int32)
    hub_rows = 600 + rng.choice(600, size=350, replace=False)
    src[hub_rows] = 0
    t = np.cumsum(rng.exponential(1.0, size=E)).astype(np.float32)
    msg = rng.normal(0, 1, size=(E, 4)).astype(np.float32)
    tr, va, te = port_dataset.chronological_masks(E, val_ratio=1 / 3,
                                                  test_ratio=1 / 3)
    uni = np.unique(dst)

    def ns_for(mask):
        pos = dst[mask]
        ns = rng.choice(uni, size=(int(mask.sum()), M)).astype(np.int32)
        for _ in range(4):
            bad = ns == pos[:, None]
            ns[bad] = rng.choice(uni, size=int(bad.sum()))
        return ns

    return port_dataset.TemporalData(
        name="hub-blocks", src=src, dst=dst, t=t, msg=msg, train_mask=tr,
        val_mask=va, test_mask=te, val_ns=ns_for(va), test_ns=ns_for(te))


def test_over_255_blocks_takes_u16_block_ids():
    data = _hub_data()
    b = _port(data, _raw(batch_size=600))
    assert int(b.blocks_for("val").max()) + 1 > 255
    assert b._eval_unique_bucket("val") > 256
    a = _port(data, _raw(batch_size=600))
    for eng in (a, b):
        eng.train_epoch()
    assert a._evaluate_chunked("val") == b.evaluate("val")
    assert b.last_eval_trace["protocol"] == "slot_unique"
    _assert_packers_equal(a, b)


def _shifted_times(data):
    """The stream with its clock moved so that its first events come
    before time 0."""
    return dataclasses.replace(data, t=data.t - data.t[len(data.t) // 4])


@pytest.mark.parametrize("train,stream,reason", [
    (dict(max_intra_block=None), None, "max_intra_block"),
    (dict(max_intra_block=300), None, "max_intra_block"),
    ({}, _shifted_times, "negative event timestamps")],
    ids=["intra-cap-none", "intra-cap-300", "negative-times"])
def test_gate_log_names_reason_once(capsys, train, stream, reason):
    """Each structural reason closes the gate, is said once per engine,
    and the pass runs by column chunks."""
    data = port_dataset.synthetic("gate-log", num_edges=1200, num_nodes=100,
                                  msg_dim=4, num_neg=5, seed=7)
    if stream is not None:
        data = stream(data)
    e = _port(data, _raw(**train))
    assert e._eval_unique_bucket("val") is None
    out = capsys.readouterr().out
    assert out.count("slot-unique protocol off") == 1 and reason in out
    assert 0.0 < e.evaluate("val") <= 1.0
    assert e.last_eval_trace["protocol"] == "column_chunk"
    assert "slot-unique" not in capsys.readouterr().out


@pytest.mark.parametrize("num_nodes,num_neg,jax_auto", [
    (300, 99, True), (60000, 20, False)], ids=["small-n", "large-n"])
def test_gate_opens_whatever_the_dedup(num_nodes, num_neg, jax_auto):
    """The port's gate opens on a stream of few nodes and on one of many
    nodes, where the JAX "auto" estimate of per-block candidate dedup is
    under 1.5x and closes the JAX Engine's (tests/test_eval_unique.py
    :216-235); the slot-unique pass equals the column-chunk pass there."""
    raw = {"sampling": [{"neighbor": [5]}],
           "gnn": [{"dim_out": 16, "att_head": 2, "dim_time": 16}],
           "train": [{"batch_size": 500, "frozen_memory": True}]}
    kw = dict(num_edges=4000, num_nodes=num_nodes, msg_dim=4,
              num_neg=num_neg, seed=5)
    jdata = jax_synthetic("gate", **kw)
    jeng = JaxEngine(jdata, jax_config(raw))
    assert jeng._eval_unique_active("val", jdata.val_ns, 500)[0] == jax_auto
    data = port_dataset.synthetic("gate", **kw)
    a, b = _port(data, raw), _port(data, raw)
    assert b._eval_unique_bucket("val") >= 16
    assert a._evaluate_chunked("val") == b.evaluate("val")
    assert b.last_eval_trace["protocol"] == "slot_unique"
    _assert_packers_equal(a, b)


@pytest.mark.parametrize("value", [True, False, "auto"])
def test_eval_slot_unique_key_is_refused(value):
    """The JAX knob has no counterpart in the port: a config that sets it
    is refused rather than ignored."""
    with pytest.raises(ValueError, match="eval_slot_unique"):
        parse_config_dict({"train": [{"eval_slot_unique": value}]})


class _HandsBack:
    """The packer as if every batch had an intra window over 255."""

    def __init__(self, packer):
        self._packer = packer

    def pack_wire_dedup_submit(self, *args, **kw):
        return True

    def pack_wire_dedup_fetch(self):
        return None

    def __getattr__(self, name):
        return getattr(self._packer, name)


def test_handed_back_batch_raises_instead_of_repacking():
    """A batch the packer hands back is packed again into another wire by
    the shared pack-ahead; the slot-unique pass raises rather than
    evaluate it."""
    eng = _port(_data(), _raw())
    eng.packer = _HandsBack(eng.packer)
    with pytest.raises(RuntimeError, match="unrepresentable"):
        eng.evaluate("val")


# ------------------------------------------------ the ragged-stream lockstep
RAGGED_NEG = 24


def _ragged(synthetic, metric):
    """The eval-unique stream with 24 negatives a row, each row cut to a
    seeded length in 1..24 (tests/test_convert_tgb.py::_RaggedDataset),
    as an object array of the package's own TemporalData."""
    base = _data(synthetic, num_neg=RAGGED_NEG)

    def cut(ns, seed):
        rng = np.random.default_rng(seed)
        out = np.empty(len(ns), object)
        for i, row in enumerate(ns):
            out[i] = row[:int(rng.integers(1, ns.shape[1] + 1))]
        return out

    return dataclasses.replace(base, val_ns=cut(base.val_ns, 7),
                               test_ns=cut(base.test_ns, 8),
                               eval_metric=metric)


@pytest.fixture(scope="module", params=[
    ("pad_mask", "mrr"), ("pad_mask", "hits@10"),
    ("truncate_min", "mrr"), ("truncate_min", "hits@10")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def ragged_lockstep(request):
    """JAX and port engines on the ragged stream after one lockstep train
    epoch, and the packer states to evaluate from."""
    mode, metric = request.param
    jeng, peng = _jax_and_port(
        _ragged(jax_synthetic, metric), _ragged(port_dataset.synthetic,
                                                metric),
        _raw(neg_mode=mode, eval_neg_chunk=5))
    return jeng, peng, jeng.packer.snapshot(), peng.packer.snapshot()


@pytest.mark.parametrize("unique", [True, False],
                         ids=["slot_unique", "column_chunk"])
def test_ragged_negatives_match_jax(ragged_lockstep, unique):
    jeng, peng, jsnap, psnap = ragged_lockstep
    jeng.packer.restore(jsnap)
    peng.packer.restore(psnap)
    jeng.config.train.eval_slot_unique = unique
    values = []
    for split in ("val", "test"):
        ns = peng.data.val_ns if split == "val" else peng.data.test_ns
        assert jeng._eval_unique_active(split, ns, 150)[0] == unique
        jm = jeng.evaluate(split)
        pm = peng.evaluate(split) if unique else peng._evaluate_chunked(split)
        assert peng.last_eval_trace["protocol"] == (
            "slot_unique" if unique else "column_chunk")
        assert abs(pm - jm) <= MRR_TOL, (split, pm, jm)
        _assert_packers_equal(peng, jeng)
        values.append(pm)
    assert all(0.0 < v <= 1.0 for v in values)
    if peng.config.train.eval_neg_mode == "pad_mask":
        assert values[0] < 1.0           # hits@10 of up to 24 negatives


def test_pad_mask_crosses_with_the_wire(monkeypatch):
    """In pad+mask mode every eval wire carries its (B, ·) negative mask
    in the same ``wire_to_device`` call, under both protocols."""
    seen = []

    def spy(wire, device, *extra):
        seen.append([None if a is None else (a.dtype, a.shape)
                     for a in extra])
        return wire_to_device(wire, device, *extra)

    monkeypatch.setattr(port_train, "wire_to_device", spy)
    data = _ragged(port_dataset.synthetic, "mrr")
    for unique, mp in ((True, 256), (False, 5)):
        eng = _port(data, _raw(neg_mode="pad_mask", eval_neg_chunk=5,
                               sanity_batches=1))
        eng.train_epoch()
        seen.clear()
        (eng.evaluate if unique else eng._evaluate_chunked)("val")
        tr = eng.last_eval_trace
        # one copy a batch (slot-unique) or a chunk (column chunks)
        assert len(seen) == (tr["batches"] if unique else tr["chunks"])
        for extra in seen:
            assert len(extra) == 1 and extra[0][0] == np.bool_
            assert extra[0][1][0] == 150 and extra[0][1][1] <= mp


def test_wire_to_device_stages_extra_arrays():
    from tgb_tgn_dgl_tpu_torch.ops.wire import WirePack
    rng = np.random.default_rng(0)
    wire = WirePack(*[rng.integers(0, 9, 5).astype(np.int32)
                      for _ in WirePack._fields])
    mask = rng.random((3, 7)) < 0.5
    got, m, none = wire_to_device(wire, "cpu", mask, None)
    assert none is None and m.dtype.is_floating_point is False
    np.testing.assert_array_equal(m.numpy(), mask)
    for a, b in zip(got, wire):
        np.testing.assert_array_equal(a.numpy(), b)
    assert isinstance(wire_to_device(wire, "cpu"), WirePack)
