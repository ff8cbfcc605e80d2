"""The port's native packer (tgb_tgn_dgl_tpu_torch/csrc/packer.cpp through
data/native_packer.py) on the CPU, exactly:

  * its full-grid ``pack`` equals the port's numpy StreamPacker field by
    field, with the stream state after every batch;
  * its ``pack_wire`` and ``pack_wire_dedup`` equal the JAX package's
    NativeStreamPacker in every field's dtype and value;
  * submit/fetch gives the wires of the synchronous calls, with sync calls
    interleaved, and hands a batch with an intra window over 255 back;
  * a compiler that fails, or is missing, makes the first
    ``NativeStreamPacker`` raise with the compiler's words.

Cases: train batches, eval batches with 2-D negatives, a mailbox ring of
S = 2, ``max_intra_block=None`` and a cap, reset and snapshot/restore,
and the ``snapshot`` a checkpoint reads against the JAX
NativeStreamPacker's state views (``cache_nbr`` … ``mail_ptr``)."""
import numpy as np
import pytest

from tgb_tgn_dgl_tpu.data.build_hostops import build_if_needed
from tgb_tgn_dgl_tpu.data.native_packer import \
    NativeStreamPacker as JaxNativePacker
from tgb_tgn_dgl_tpu.data.packer import PackerConfig as JaxPackerConfig
from tgb_tgn_dgl_tpu_torch.data import dataset as pdata
from tgb_tgn_dgl_tpu_torch.data.dependency import (dependency_aware_batch,
                                                   get_block)
from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
from tgb_tgn_dgl_tpu_torch.data.packer import (Pack, PackerConfig,
                                               StreamPacker)
from tgb_tgn_dgl_tpu_torch.ops import _build

STATE = ("cache_nbr", "cache_eid", "cache_t", "clock", "cur_e_id",
         "mail_ptr")                            # snapshot() order


@pytest.fixture(scope="module")
def built():
    """Both native libraries: the port's (g++ into its _build/) and the
    JAX package's (its own build step), built here and not at import."""
    _build.host_library("packer")
    assert build_if_needed(), "the JAX package's libhostops.so did not build"


def _assert_same_pack(a: Pack, b: Pack, ctx=""):
    for f in Pack._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (ctx, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: {f}")
        else:
            assert x == y, (ctx, f, x, y)


def _assert_same_wire(a, b, ctx=""):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, (ctx, f)
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (
            ctx, f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: {f}")


def _assert_same_state(a, b, ctx=""):
    for name, x, y in zip(STATE, a.snapshot(), b.snapshot()):
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: {name}")


def _stream(S=1, cap=8, num_nodes=80, E=600, B=150, seed=0):
    data = pdata.synthetic("tgbl-wiki-small", num_edges=E, num_nodes=num_nodes,
                           msg_dim=4, num_neg=4, seed=seed)
    kw = dict(num_neighbors=5, batch_size=B, max_intra_block=cap,
              mailbox_size=S)
    return data, kw


def _batches(data, B, eval_every=0, M=4, seed=1):
    """(args, kwargs) of each batch: train batches with one negative per
    event, and with ``eval_every`` eval batches of M negatives, the first
    chunk leaving the state alone, the last advancing it."""
    rng = np.random.default_rng(seed)
    blocks = dependency_aware_batch(data.src, data.dst, B)
    for bi, lo in enumerate(range(0, len(data.src), B)):
        rows = np.arange(lo, min(lo + B, len(data.src)))
        src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
        blk = blocks[rows]
        if eval_every and bi % eval_every == 1:
            neg = rng.choice(data.unique_dst(), (len(rows), M)).astype(
                np.int32)
            half = M // 2
            yield ((src, dst, t, rows, blk, neg[:, :half]),
                   dict(eval_mode=True, insert=False, write_mail=False))
            yield ((src, dst, t, rows, blk, neg[:, half:]),
                   dict(eval_mode=True))
        else:
            neg = rng.choice(data.unique_dst(), len(rows)).astype(np.int32)
            yield (src, dst, t, rows, blk, neg), {}


CASES = [dict(), dict(eval_every=2), dict(S=2), dict(cap=None),
         dict(cap=None, eval_every=2, S=2)]
IDS = ["train", "eval_2d", "mailbox_s2", "exact_p", "exact_p_eval_s2"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pack_equals_numpy_packer(built, case):
    case = dict(case)
    eval_every = case.pop("eval_every", 0)
    data, kw = _stream(**case)
    mine = NativeStreamPacker(data.num_nodes, PackerConfig(**kw))
    ref = StreamPacker(data.num_nodes, PackerConfig(**kw))
    for i, (args, akw) in enumerate(_batches(data, kw["batch_size"],
                                             eval_every)):
        _assert_same_pack(mine.pack(*args, **akw), ref.pack(*args, **akw),
                          f"batch {i}")
        _assert_same_state(mine, ref, f"batch {i}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wires_equal_jax_native_packer(built, case):
    case = dict(case)
    eval_every = case.pop("eval_every", 0)
    data, kw = _stream(**case)
    for method in ("pack_wire", "pack_wire_dedup"):
        mine = NativeStreamPacker(data.num_nodes, PackerConfig(**kw))
        ref = JaxNativePacker(data.num_nodes, JaxPackerConfig(**kw))
        for i, (args, akw) in enumerate(_batches(data, kw["batch_size"],
                                                 eval_every)):
            (w, p), (rw, rp) = (getattr(mine, method)(*args, **akw),
                                getattr(ref, method)(*args, **akw))
            assert p == rp and type(w).__name__ == type(rw).__name__
            _assert_same_wire(w, rw, f"{method} batch {i}")
        _assert_same_state(mine, ref, method)


def test_reset_snapshot_restore(built):
    data, kw = _stream(S=2)
    mine = NativeStreamPacker(data.num_nodes, PackerConfig(**kw))
    ref = StreamPacker(data.num_nodes, PackerConfig(**kw))
    jobs = list(_batches(data, kw["batch_size"]))
    for args, akw in jobs[:2]:
        mine.pack(*args, **akw)
        ref.pack(*args, **akw)
    snap_m, snap_r = mine.snapshot(), ref.snapshot()
    for x, y in zip(snap_m, snap_r):
        np.testing.assert_array_equal(x, y)
    mine.reset_cache()
    ref.reset_cache()
    _assert_same_state(mine, ref, "after reset")
    assert mine.cur_e_id == 0
    mine.restore(snap_m)
    ref.restore(snap_r)
    _assert_same_state(mine, ref, "after restore")
    for args, akw in jobs[2:]:
        _assert_same_pack(mine.pack(*args, **akw), ref.pack(*args, **akw),
                          "after restore")
    # an explicit insert, as the eval protocol's stream advance does
    src, dst, t = data.src[:20], data.dst[:20], data.t[:20]
    mine.insert(src, dst, t)
    ref.insert(src, dst, t)
    _assert_same_state(mine, ref, "after insert")


@pytest.mark.parametrize("S", [1, 2])
def test_state_views_equal_jax_native_packer(built, S):
    """After the same inserts and packs, each field of ``snapshot()``
    equals the JAX NativeStreamPacker's state view in dtype and value;
    ``restore`` of the JAX views into a reset packer gives back the same
    state, and both packers then pack the same wires."""
    data, kw = _stream(S=S)
    mine = NativeStreamPacker(data.num_nodes, PackerConfig(**kw))
    ref = JaxNativePacker(data.num_nodes, JaxPackerConfig(**kw))
    jobs = list(_batches(data, kw["batch_size"], eval_every=2))
    for args, akw in jobs[:3]:
        mine.pack_wire(*args, **akw)
        ref.pack_wire(*args, **akw)
    src, dst, t = data.src[:20], data.dst[:20], data.t[:20]
    mine.insert(src, dst, t)
    ref.insert(src, dst, t)
    for name, a in zip(STATE, mine.snapshot()):
        b = getattr(ref, name)
        if name == "cur_e_id":
            assert a == b and a > 0
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    nbr, _, _, clock, _, _ = mine.snapshot()
    assert (clock > 0).any() and (nbr >= 0).any()
    views = tuple(getattr(ref, name) for name in STATE)
    mine.reset_cache()
    mine.restore(views)
    _assert_same_state(mine, ref, "after restore")
    for i, (args, akw) in enumerate(jobs[3:]):
        (w, p), (rw, rp) = (mine.pack_wire(*args, **akw),
                            ref.pack_wire(*args, **akw))
        assert p == rp
        _assert_same_wire(w, rw, f"batch {i} after restore")


@pytest.mark.parametrize("eval_every", [0, 2], ids=["train", "eval_2d"])
def test_submit_fetch_equals_sync(built, eval_every):
    """The pack-ahead gives the synchronous wires, with a sync call (a
    snapshot, which waits for the worker) between every submit and fetch,
    and leaves the same stream state."""
    data, kw = _stream(S=2, cap=None)
    sync = NativeStreamPacker(data.num_nodes, PackerConfig(**kw))
    ahead = NativeStreamPacker(data.num_nodes, PackerConfig(**kw))
    pend = False
    got, want = [], []
    for args, akw in _batches(data, kw["batch_size"], eval_every):
        want.append(sync.pack_wire_dedup(*args, **akw))
        if pend:
            got.append(ahead.pack_wire_dedup_fetch())
        assert ahead.pack_wire_dedup_submit(*args, **akw)
        pend = True
        if len(got) % 2:
            ahead.snapshot()
    got.append(ahead.pack_wire_dedup_fetch())
    assert len(got) == len(want)
    for i, ((g, gp), (w, wp)) in enumerate(zip(got, want)):
        assert gp == wp
        _assert_same_wire(g, w, f"batch {i}")
    _assert_same_state(ahead, sync)
    # no job outstanding: fetch reports nothing to read
    assert ahead.pack_wire_dedup_fetch() is None


def test_wide_intra_window_is_handed_back(built):
    """A hub in 300 events of one batch needs P = 512 > 255: the dedup
    wire cannot carry it, fetch returns None with the state untouched, and
    pack_wire then packs the same batch as the JAX packer does."""
    n = 300
    src = np.zeros(n, np.int32)                    # one hub source
    dst = (np.arange(n) % 40 + 1).astype(np.int32)
    t = np.arange(n, dtype=np.float32)
    rows = np.arange(n)
    args = (src, dst, t, rows, get_block(src, dst),
            np.full(n, 41, np.int32))
    kw = dict(num_neighbors=4, batch_size=n, max_intra_block=None)
    mine = NativeStreamPacker(50, PackerConfig(**kw))
    ref = JaxNativePacker(50, JaxPackerConfig(**kw))
    assert mine.pack_wire_dedup(*args) is None
    assert mine.pack_wire_dedup_submit(*args)
    assert mine.pack_wire_dedup_fetch() is None
    assert mine.cur_e_id == 0
    (w, p), (rw, rp) = mine.pack_wire(*args), ref.pack_wire(*args)
    assert p == rp == 512
    _assert_same_wire(w, rw)
    _assert_same_state(mine, ref)


@pytest.mark.parametrize("compiler", ["false", "/nonexistent/bin/g++"],
                         ids=["fails", "missing"])
def test_failing_compiler_raises(compiler, monkeypatch):
    """No fallback to the numpy packer: the build's failure reaches the
    caller (the compiler is part of the library's name, so the build runs
    anew)."""
    monkeypatch.setattr(_build, "CXX", compiler)
    assert not _build.host_target("packer").exists()
    with pytest.raises(RuntimeError, match="csrc/packer.cpp"):
        NativeStreamPacker(10, PackerConfig(num_neighbors=2, batch_size=4))
