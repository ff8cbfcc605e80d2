"""The port's wires (ops/wire.py) on CPU tensors, exactly: each expansion
equals ``to_device`` of the numpy pack of the same batch (the plain
version) in every field's dtype and value, and equals the JAX package's
expansion of the same wire.

  * ``expand_dedup`` of the dedup wire with its Δt (train and eval
    batches) and of the eval-lean wire (Δt derived from the event-time
    table);
  * ``expand_wire`` of the plain WirePack and of the CompactWire;
  * ``_mw_from_slots`` in both encodings (u8 for S ≤ 254, i32 above);
  * a stream of more than 65,535 nodes, where every index field ships as
    i32;
  * the train-lean wire (``train_lean_dedup``): the host post-pass equals
    JAX's, its expansion equals the full-Δt wire's, the numpy pack's and
    JAX's expansion exactly, over batches whose clocks the device never
    saw, with duplicate timestamps and colliding negatives (JAX
    tests/test_wire.py::test_dedup_wire_train_lean_exact); both guards
    send the full wire back; the native packer's ``clock_snapshot`` is a
    copy; an Engine with ``wire_train_lean`` trains and evaluates exactly
    as one without it, and a batch the packer hands back crosses as a
    compact wire with its Δt."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgb_tgn_dgl_tpu.ops import wire as jwire
from tgb_tgn_dgl_tpu_torch.data import dataset as pdata
from tgb_tgn_dgl_tpu_torch.data.dependency import dependency_aware_batch
from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
from tgb_tgn_dgl_tpu_torch.data.packer import (DevicePack, PackerConfig,
                                               StreamPacker, to_device)
from tgb_tgn_dgl_tpu_torch.ops import _build
from tgb_tgn_dgl_tpu_torch.ops.wire import (CompactWire, DedupWire, WirePack,
                                            _mw_from_slots, compact_wire,
                                            eval_lean_dedup, expand_any,
                                            expand_dedup, expand_wire,
                                            nb_bucket_of, train_lean_dedup,
                                            wire_nbytes, wire_to_device)

K = 5


@pytest.fixture(scope="module", autouse=True)
def built():
    _build.host_library("packer")


def _assert_pack_equal(got: DevicePack, want: DevicePack, ctx):
    for f in DevicePack._fields:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:                  # nbr_rslot at one layer
            assert a is None, (ctx, f)
            continue
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype, (ctx, f)
        assert a.shape == b.shape, (ctx, f, a.shape, b.shape)
        assert torch.equal(a, b), f"{ctx}: {f}"


def _assert_equals_jax(got: DevicePack, jax_pack, ctx):
    for f in DevicePack._fields:
        if getattr(jax_pack, f) is None:
            assert getattr(got, f) is None, (ctx, f)
            continue
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(jax_pack, f)),
            err_msg=f"{ctx}: {f} against JAX")


def _jax_wire(wire):
    """The same numpy wire as the JAX package's type."""
    cls = getattr(jwire, type(wire).__name__)
    return cls(**{f: None if a is None else jnp.asarray(a)
                  for f, a in wire._asdict().items()})


def _run(N=80, S=1, cap=8, M=4, E=600, B=150, seed=0, num_nodes=None):
    """Yield (batch, eval_mode, want, (DedupWire, P), (WirePack, P),
    blocks, event times, N) over one stream, three packers in lockstep:
    numpy (``want`` is ``to_device`` of its pack), native dedup, native
    WirePack; eval batches from the third on."""
    r = np.random.default_rng(seed)
    t_all = np.sort(r.uniform(0, 1e6, E)).astype(np.float32)
    src_all = r.integers(0, N, E).astype(np.int32)
    dst_all = r.integers(0, N, E).astype(np.int32)
    blocks_all = dependency_aware_batch(src_all, dst_all, B)
    n_nodes = num_nodes or N
    cfg = PackerConfig(num_neighbors=K, batch_size=B, max_intra_block=cap,
                       mailbox_size=S)
    plain = StreamPacker(n_nodes, cfg)
    dedup = NativeStreamPacker(n_nodes, cfg)
    wires = NativeStreamPacker(n_nodes, cfg)
    for bi, lo in enumerate(range(0, E, B)):
        hi = min(lo + B, E)
        rows = np.arange(lo, hi)
        em = bi >= 2
        neg = r.integers(0, N, (hi - lo, M if em else 1)).astype(np.int32)
        if not em:
            neg = neg[:, 0]
        args = (src_all[lo:hi], dst_all[lo:hi], t_all[lo:hi], rows,
                blocks_all[lo:hi], neg)
        want = to_device(plain.pack(*args, eval_mode=em), "cpu")
        yield (bi, em, want, dedup.pack_wire_dedup(*args, eval_mode=em),
               wires.pack_wire(*args, eval_mode=em), blocks_all[lo:hi],
               torch.from_numpy(t_all), n_nodes)


CASES = [dict(), dict(S=2, M=7), dict(cap=None, seed=3), dict(S=300)]
IDS = ["s1", "s2_m7", "exact_p", "s300_i32_slots"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_expand_dedup_exact(case):
    for bi, em, want, (w, P), _, blocks, times, N in _run(**case):
        got = expand_dedup(wire_to_device(w, "cpu"), K, P, N)
        _assert_pack_equal(got, want, f"dedup batch {bi}")
        _assert_equals_jax(got, jwire.expand_dedup(_jax_wire(w), K, P, N),
                           f"dedup batch {bi}")
        if not em:
            continue
        nbb = nb_bucket_of(blocks)
        lean = eval_lean_dedup(w, blocks, nbb)
        assert lean.cache_dt is None and lean.blk_max.shape == (nbb,)
        assert wire_nbytes(lean) < wire_nbytes(w)
        got = expand_any(wire_to_device(lean, "cpu"), K, P, N, times)
        _assert_pack_equal(got, want, f"eval-lean batch {bi}")
        _assert_equals_jax(
            got, jwire.expand_dedup(_jax_wire(lean), K, P, N,
                                    ev_times=jnp.asarray(times.numpy())),
            f"eval-lean batch {bi}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_expand_wire_plain_and_compact_exact(case):
    for bi, em, want, _, (w, P), _, _, N in _run(**case):
        assert isinstance(w, WirePack)
        got = expand_wire(wire_to_device(w, "cpu"), K, P, N)
        _assert_pack_equal(got, want, f"wire batch {bi}")
        _assert_equals_jax(got, jwire.expand_wire(_jax_wire(w), K, P, N),
                           f"wire batch {bi}")
        cw = compact_wire(w, N, P, case.get("S", 1))
        assert isinstance(cw, CompactWire)
        assert wire_nbytes(cw) < wire_nbytes(w)
        got = expand_any(wire_to_device(cw, "cpu"), K, P, N)
        _assert_pack_equal(got, want, f"compact batch {bi}")
        _assert_equals_jax(got, jwire.expand_wire(_jax_wire(cw), K, P, N),
                           f"compact batch {bi}")


def test_many_nodes_ship_i32_indices():
    """70,001 nodes: node ids and the uniq table overflow uint16, so they
    ship as int32 (ids drawn from the first 80 keep the stream small)."""
    seen = set()
    for bi, em, want, (w, P), (pw, _), blocks, times, N in _run(
            num_nodes=70001):
        seen.add((w.ev_src.dtype, w.uniq_nid.dtype, w.ev_neg.dtype))
        for f in ("ev_src", "ev_dst", "ev_neg", "uniq_nid"):
            assert getattr(w, f).dtype == np.int32, f
        assert w.root_loc.dtype == np.uint16
        got = expand_dedup(wire_to_device(w, "cpu"), K, P, N)
        _assert_pack_equal(got, want, f"dedup batch {bi}")
        cw = compact_wire(pw, N, P, 1)
        assert cw.ev_src.dtype == np.int32 and cw.uniq_nid.dtype == np.int32
        _assert_pack_equal(expand_wire(wire_to_device(cw, "cpu"), K, P, N),
                           want, f"compact batch {bi}")
        if em:
            lean = eval_lean_dedup(w, blocks, nb_bucket_of(blocks))
            _assert_pack_equal(expand_dedup(wire_to_device(lean, "cpu"), K,
                                            P, N, times),
                               want, f"eval-lean batch {bi}")
    assert seen == {(np.dtype(np.int32),) * 3}


@pytest.mark.parametrize("dtype", [np.uint8, np.int32], ids=["u8", "i32"])
def test_mw_from_slots_both_encodings(dtype):
    B, N = 64, 500
    r = np.random.default_rng(7)
    ev_src = r.integers(0, N, B).astype(np.int32)
    ev_dst = r.integers(0, N, B).astype(np.int32)
    ev_t = np.sort(r.uniform(0, 100, B)).astype(np.float32)
    ev_idx = np.arange(1000, 1000 + B, dtype=np.int32)
    slots = r.integers(0, 4, 2 * B)
    none = 255 if dtype == np.uint8 else -1
    mw_slot = np.where(r.random(2 * B) < 0.3, none, slots).astype(dtype)
    got = _mw_from_slots(*(torch.from_numpy(a) for a in
                           (mw_slot, ev_src, ev_dst, ev_t, ev_idx)), N)
    want = jwire._mw_from_slots(*(jnp.asarray(a) for a in
                                  (mw_slot, ev_src, ev_dst, ev_t, ev_idx)), N)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == N).sum() == (mw_slot == none).sum()


def test_wire_to_device_keeps_none_and_widens_uint16():
    """Fields of every width share one staging buffer: each comes back
    with its dtype, shape and values, empty and odd-sized ones included."""
    w = DedupWire(*([None] * len(DedupWire._fields)))._replace(
        ev_src=np.arange(3, dtype=np.uint16) * 30000,
        ev_t=np.array([0.5, -1.0], np.float32),
        ev_valid=np.array([True, False, True]),
        ev_neg=np.zeros((0, 4), np.int32),
        intra_cnt=np.arange(5, dtype=np.uint8),
        ne_ent=np.arange(6, dtype=np.int32).reshape(3, 2))
    d = wire_to_device(w, "cpu")
    assert d.ev_src.dtype == torch.int32
    assert d.ev_src.tolist() == [0, 30000, 60000]
    for f in ("ev_t", "ev_valid", "ev_neg", "intra_cnt", "ne_ent"):
        a = getattr(w, f)
        assert getattr(d, f).numpy().dtype == a.dtype, f
        np.testing.assert_array_equal(getattr(d, f).numpy(), a, err_msg=f)
    assert all(getattr(d, f) is None for f in DedupWire._fields
               if getattr(w, f) is None)


def test_jax_and_port_wires_have_the_same_fields():
    """The port's wire types keep the JAX names and order, the train-lean
    wire's ``clock0`` included."""
    for cls in (WirePack, CompactWire, DedupWire):
        assert getattr(jwire, cls.__name__)._fields == cls._fields


# ------------------------------------------------------------ train-lean
def _train_lean_stream(S, seed, N=60, B=150, E=600):
    """JAX tests/test_wire.py::test_dedup_wire_train_lean_exact's stream:
    few nodes (endpoints and negatives collide in a block), 10 equal
    timestamps; yields (args, to_device of the numpy pack, the native
    dedup wire and its P, the clocks before the batch, blocks, times)."""
    r = np.random.default_rng(seed)
    cfg = PackerConfig(num_neighbors=K, batch_size=B, max_intra_block=8,
                       mailbox_size=S)
    plain, native = StreamPacker(N, cfg), NativeStreamPacker(N, cfg)
    t_all = np.sort(r.uniform(0, 1e6, E)).astype(np.float32)
    t_all[100:110] = t_all[100]
    src_all = r.integers(0, N, E).astype(np.int32)
    dst_all = r.integers(0, N, E).astype(np.int32)
    blocks_all = dependency_aware_batch(src_all, dst_all, B)
    times = torch.from_numpy(t_all)
    for lo in range(0, E, B):
        rows = np.arange(lo, lo + B)
        args = (src_all[rows], dst_all[rows], t_all[rows], rows,
                blocks_all[rows], r.integers(0, N, B).astype(np.int32))
        clock = native.clock_snapshot()
        np.testing.assert_array_equal(clock, plain.clock)
        want = to_device(plain.pack(*args), "cpu")
        yield (want, native.pack_wire_dedup(*args), clock,
               blocks_all[rows], times)


@pytest.mark.parametrize("S,seed", [(1, 3), (2, 7)], ids=["s1", "s2"])
def test_train_lean_wire_exact(S, seed):
    N, nbb = 60, 64
    for bi, (want, (w, P), clock, blocks, times) in enumerate(
            _train_lean_stream(S, seed)):
        lean = train_lean_dedup(w, blocks, nbb, clock)
        assert lean.cache_dt is None and lean.self_dt is None
        assert lean.ia_dt is None and lean.clock0.shape == w.uniq_nid.shape
        assert wire_nbytes(lean) < wire_nbytes(w)
        jl = jwire.train_lean_dedup(w, blocks, nbb, clock)
        for f in DedupWire._fields:
            a, b = getattr(lean, f), getattr(jl, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
        got = expand_dedup(wire_to_device(lean, "cpu"), K, P, N, times)
        full = expand_dedup(wire_to_device(w, "cpu"), K, P, N)
        _assert_pack_equal(got, want, f"train-lean batch {bi}")
        _assert_pack_equal(got, full, f"train-lean batch {bi} vs full Δt")
        _assert_equals_jax(
            got, jwire.expand_dedup(_jax_wire(jl), K, P, N,
                                    ev_times=jnp.asarray(times.numpy())),
            f"train-lean batch {bi}")
    assert bi > 0 and clock.any()      # later batches read real clocks


def test_train_lean_guards_send_the_full_wire():
    """A block bucket with 3·B·nb_bucket ≥ 2^31 (the int32 order key
    would wrap) or a block count over the id field: the wire comes back
    with its Δt."""
    (want, (w, P), clock, blocks, times), = itertools.islice(
        _train_lean_stream(1, 11, E=150), 1)
    B = w.ev_t.shape[0]
    huge = 2 ** 31 // (3 * B) + 1
    assert train_lean_dedup(w, blocks, huge, clock) is w
    too_many = np.arange(len(blocks)) % 40       # 40 blocks in bucket 16
    assert train_lean_dedup(w, too_many, 16, clock) is w
    assert jwire.train_lean_dedup(w, too_many, 16, clock) is w
    assert train_lean_dedup(w, blocks, 64, clock).clock0 is not None


def test_clock_snapshot_is_a_copy():
    cfg = PackerConfig(num_neighbors=K, batch_size=16, max_intra_block=8)
    pk = NativeStreamPacker(40, cfg)
    r = np.random.default_rng(2)
    snap = pk.clock_snapshot()
    src, dst = (r.integers(0, 40, 16).astype(np.int32) for _ in range(2))
    t = np.sort(r.uniform(1, 10, 16)).astype(np.float32)
    pk.pack_wire_dedup(src, dst, t, np.arange(16),
                       dependency_aware_batch(src, dst, 16),
                       r.integers(0, 40, 16).astype(np.int32))
    assert not snap.any() and pk.clock_snapshot().any()
    np.testing.assert_array_equal(pk.clock_snapshot(), pk.snapshot()[3])


@pytest.mark.parametrize("hands_back", [False, True],
                         ids=["dedup", "handed_back"])
def test_engine_train_lean_matches_full_wire(hands_back):
    """The same engine with and without ``wire_train_lean``: equal losses,
    parameters and val MRR, every train wire train-lean (or, when the
    packer hands each batch back, a compact wire with its Δt)."""
    from test_torch_engine import RAW, _HandsBack, _data, _with_train
    from tgb_tgn_dgl_tpu_torch.engine.train import Engine
    from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

    out = {}
    for tl in (False, True):
        eng = Engine(_data(pdata.synthetic), parse_config_dict(
            _with_train(RAW, wire_train_lean=tl)), device="cpu")
        if hands_back:
            eng.packer = _HandsBack(eng.packer)
        kinds = []
        expand = eng._expand

        def spy(wire, iw, expand=expand, kinds=kinds):
            kinds.append((type(wire).__name__,
                          getattr(wire, "clock0", None) is not None))
            return expand(wire, iw)

        eng._expand = spy
        stats = eng.train_epoch()
        train_kinds = kinds[:]
        # a handed-back eval wire cannot run the slot-unique protocol
        val = (eng._evaluate_chunked if hands_back else eng.evaluate)("val")
        out[tl] = (stats, val, eng.model.state_dict(),
                   train_kinds, eng.train_lean)
    (s0, v0, p0, k0, l0), (s1, v1, p1, k1, l1) = out[False], out[True]
    assert not l0 and l1
    assert s0 == s1 and v0 == v1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    want = ("CompactWire", False) if hands_back else ("DedupWire", True)
    assert set(k1) == {want} and len(k1) == 6
    assert set(k0) == {(want[0], False)}
