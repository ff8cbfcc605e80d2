"""Stacked attention layers (gnn.layer > 1) and vector messages in the port
(tgb_tgn_dgl_tpu_torch), held against the JAX package on the CPU with the
same numpy-seeded inputs and bridged weights, at dropout 0.

  * the same-block root slot of each in-edge (``nbr_rslot``): the hand
    case of tests/test_multilayer.py on the port's numpy packer, the
    port's numpy packer against the JAX one on a seeded stream, the
    port's native ``pack_wire`` against the JAX native packer and its own
    numpy pack, and across the compact wire in both encodings (u16 with
    0xFFFF for -1, through ``wire_to_device``; i32 on a hand-built wire
    of more than 65,535 root slots);
  * ``tgnn_embed`` at 1-3 layers, scalar and vector, frozen all-ones and
    ``local=True`` memory rows, against JAX ``tgnn_embed`` / the loss
    gradients of ``tgnn_forward``;
  * the Engine against the JAX Engine (one train epoch, val, test) with
    ``gnn.layer: 2`` (frozen and GRU memory) and with vector messages at
    one layer (frozen and memory);
  * the bridge of ``gat2`` … ``gat{L}``, the limits of ``gnn.layer`` and
    ``message_mode``, ``configs/TGN-2layer.yml``.

Tolerances as tests/test_torch_tgnn.py (embeddings 1e-5, gradients 2e-5
abs + 1e-4 rel) and tests/test_torch_engine.py (losses, parameters and
``MemoryState.mem`` 1e-4 after an epoch, MRR 1e-3; the other state fields
and the packer state exactly)."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgb_tgn_dgl_tpu.data.dataset import synthetic as jax_synthetic
from tgb_tgn_dgl_tpu.data.native_packer import \
    NativeStreamPacker as JaxNativePacker
from tgb_tgn_dgl_tpu.data.packer import PackerConfig as JaxPackerConfig
from tgb_tgn_dgl_tpu.data.packer import StreamPacker as JaxStreamPacker
from tgb_tgn_dgl_tpu.engine.train import Engine as JaxEngine
from tgb_tgn_dgl_tpu.models.tgnn import (TGNNConfig as JaxTGNNConfig,
                                         bce_loss as jax_bce_loss,
                                         init_tgnn as jax_init_tgnn,
                                         tgnn_embed as jax_tgnn_embed,
                                         tgnn_forward as jax_tgnn_forward)
from tgb_tgn_dgl_tpu.ops import wire as jwire
from tgb_tgn_dgl_tpu.utils.config import parse_config as jax_parse_config
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.bridge import (memory_state_from_jax,
                                          params_from_jax, params_to_jax)
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.dependency import (dependency_aware_batch,
                                                   get_block)
from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
from tgb_tgn_dgl_tpu_torch.data.packer import (KIND_CACHE, KIND_INTRA,
                                               KIND_INVALID, DevicePack,
                                               PackerConfig, StreamPacker,
                                               to_device)
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.models.tgnn import (TGNNConfig, bce_loss,
                                               init_tgnn, tgnn_embed,
                                               tgnn_forward)
from tgb_tgn_dgl_tpu_torch.ops import _build
from tgb_tgn_dgl_tpu_torch.ops.wire import (RSLOT_NONE_U16, CompactWire,
                                            WirePack, compact_wire,
                                            expand_wire, wire_to_device)
from tgb_tgn_dgl_tpu_torch.utils.config import (PORT_ONLY_GNN_KEYS,
                                                parse_config,
                                                parse_config_dict)

ROOT = Path(__file__).resolve().parents[1]
F, D, H, K = 6, 16, 4, 5
TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
ENGINE_TOL = 1e-4
MRR_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def built():
    _build.host_library("packer")


# ------------------------------------------------------------------ packer
def test_rslot_emission_hand_case():
    """Hand-checked nbr_rslot (tests/test_multilayer.py's case): the self
    column is the row's own slot; a cache neighbor gets the same-block
    slot iff it is rooted there; an intra partner from an earlier block
    resolves against the ROW's block roots."""
    packer = StreamPacker(10, PackerConfig(num_neighbors=2, batch_size=4,
                                           layers=2, root_bucket_lo=8))
    # history: edge 5->0 puts 5 into 0's cache (and 0 into 5's)
    packer.insert(np.array([5], np.int32), np.array([0], np.int32),
                  np.array([1.0], np.float32))
    pack = packer.pack(np.array([0, 2, 1], np.int32),
                       np.array([1, 3, 2], np.int32),
                       np.array([2.0, 2.0, 3.0], np.float32), np.arange(3),
                       np.array([0, 0, 1]), np.array([3, 0, 0], np.int32))
    rs = pack.nbr_rslot
    assert rs is not None and rs.dtype == np.int32
    k = 2
    # block 0 roots = [0, 1, 2, 3] at slots 0..3, block 1 = [0, 1, 2] at 4..6
    np.testing.assert_array_equal(pack.root_nid[:7], [0, 1, 2, 3, 0, 1, 2])
    assert [rs[r, k] for r in range(7)] == list(range(7))
    # row 0 (node 0, block 0): cache neighbor 5 is no block-0 root
    row0 = pack.nbr_kind[0, :k]
    assert (row0 == KIND_CACHE).sum() == 1
    assert rs[0, :k][row0 == KIND_CACHE][0] == -1
    # row 5 (node 1, block 1): intra partner 0 (event 0->1 of block 0) is
    # a block-1 root at slot 4
    intra = pack.nbr_kind[5] == KIND_INTRA
    assert intra.sum() == 1 and pack.nbr_nid[5][intra][0] == 0
    assert rs[5][intra][0] == 4
    # row 4 (node 0, block 1): the cache is still pre-batch (5 only)
    assert rs[4, :k][pack.nbr_kind[4, :k] == KIND_CACHE][0] == -1
    assert (rs[pack.nbr_kind == KIND_INVALID] == -1).all()
    ok = rs >= 0
    np.testing.assert_array_equal(pack.root_nid[rs[ok]], pack.nbr_nid[ok])
    assert StreamPacker(10, PackerConfig(batch_size=4)).pack(
        np.array([0], np.int32), np.array([1], np.int32),
        np.array([1.0], np.float32), np.arange(1), np.array([0]),
        np.array([2], np.int32)).nbr_rslot is None


def _stream(N=80, E=600, B=150, seed=0):
    r = np.random.default_rng(seed)
    t = np.sort(r.uniform(0, 1e6, E)).astype(np.float32)
    src = r.integers(0, N, E).astype(np.int32)
    dst = r.integers(0, N, E).astype(np.int32)
    return src, dst, t, dependency_aware_batch(src, dst, B)


def _batches(N=80, E=600, B=150, M=4, seed=0):
    """(args, kwargs) of each batch of a seeded stream: train batches,
    then from the third on eval batches in two negative chunks, only the
    last of which advances the stream state."""
    src, dst, t, blocks = _stream(N, E, B, seed)
    r = np.random.default_rng(seed + 1)
    for bi, lo in enumerate(range(0, E, B)):
        rows = np.arange(lo, min(lo + B, E))
        args = (src[rows], dst[rows], t[rows], rows, blocks[rows])
        if bi < 2:
            yield args + (r.integers(0, N, len(rows)).astype(np.int32),), {}
            continue
        neg = r.integers(0, N, (len(rows), M)).astype(np.int32)
        yield args + (neg[:, :M // 2],), dict(
            eval_mode=True, insert=False, write_mail=False)
        yield args + (neg[:, M // 2:],), dict(eval_mode=True)


PACKER = dict(num_neighbors=K, batch_size=150, max_intra_block=8)


@pytest.mark.parametrize("layers", [2, 3])
def test_numpy_rslot_equals_jax_packer(layers):
    """The port's numpy packer and the JAX one, fed the same train and
    eval batches: nbr_rslot and every other field equal exactly."""
    mine = StreamPacker(80, PackerConfig(**PACKER, layers=layers))
    ref = JaxStreamPacker(80, JaxPackerConfig(**PACKER, layers=layers))
    n_rslot = 0
    for i, (args, kw) in enumerate(_batches()):
        a, b = mine.pack(*args, **kw), ref.pack(*args, **kw)
        for f in DevicePack._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"batch {i}: {f}")
        assert a.nbr_rslot.dtype == np.int32
        n_rslot += int((a.nbr_rslot >= 0).sum() - a.num_real_roots)
    assert n_rslot > 0          # some in-edges read a layer-1 embedding


def _rslot_of_wire(w, R):
    """(cache_rslot, intra rslot at (row, col)) of a numpy WirePack."""
    real = w.ia_row != R
    return w.cache_rslot, (w.ia_row[real], w.ia_col[real], w.ia_rslot[real])


def test_native_pack_wire_equals_jax_and_numpy():
    """``pack_wire`` at layers=2: every field equal to the JAX native
    packer's WirePack (rslot fields included), its rslot equal to the
    numpy pack's nbr_rslot cell by cell, and the stream states equal."""
    kw = dict(PACKER, layers=2)
    mine = NativeStreamPacker(80, PackerConfig(**kw))
    jref = JaxNativePacker(80, JaxPackerConfig(**kw))
    plain = StreamPacker(80, PackerConfig(**kw))
    for i, (args, akw) in enumerate(_batches()):
        (w, p), (jw, jp) = (mine.pack_wire(*args, **akw),
                            jref.pack_wire(*args, **akw))
        pack = plain.pack(*args, **akw)
        assert p == jp and w.cache_rslot is not None
        for f in WirePack._fields:
            a, b = getattr(w, f), getattr(jw, f)
            assert a.dtype == b.dtype, (i, f)
            np.testing.assert_array_equal(a, b, err_msg=f"batch {i}: {f}")
        R = w.root_loc.shape[0]
        cache_rs, (row, col, ia_rs) = _rslot_of_wire(w, R)
        want = pack.nbr_rslot
        np.testing.assert_array_equal(cache_rs, want[:, :K])
        np.testing.assert_array_equal(ia_rs, want[row, K + 1 + col])
    for x, y in zip(mine.snapshot(), plain.snapshot()):
        np.testing.assert_array_equal(x, y)


def test_native_packer_refuses_the_dedup_paths_above_one_layer():
    """At layers > 1 the worker refuses the job (its dedup wire carries no
    rslot) with the state untouched, and the full-grid ``pack`` (no
    rslot) asserts."""
    packer = NativeStreamPacker(80, PackerConfig(**PACKER, layers=2))
    args, kw = next(_batches())
    before = packer.snapshot()
    assert packer.pack_wire_dedup_submit(*args, **kw) is False
    for x, y in zip(before, packer.snapshot()):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(AssertionError, match="nbr_rslot"):
        packer.pack(*args, **kw)
    with pytest.raises(NotImplementedError, match="recent"):
        NativeStreamPacker(80, PackerConfig(**PACKER, strategy="uniform"))


def _assert_device_pack_equal(got, want, ctx):
    for f in DevicePack._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        assert torch.equal(a, b), f"{ctx}: {f}"


def test_compact_wire_u16_carries_rslot_exactly():
    """Native WirePack -> compact_wire (u16 rslot, 0xFFFF for -1) ->
    ``wire_to_device``, where the sentinel arrives widened to 65535 ->
    ``expand_wire``: every field, nbr_rslot included, equals
    ``to_device`` of the numpy pack, and the JAX expansion of the same
    compact wire gives the same nbr_rslot."""
    kw = dict(PACKER, layers=2)
    native = NativeStreamPacker(80, PackerConfig(**kw))
    plain = StreamPacker(80, PackerConfig(**kw))
    for i, (args, akw) in enumerate(_batches()):
        w, iw = native.pack_wire(*args, **akw)
        want = to_device(plain.pack(*args, **akw), "cpu")
        cw = compact_wire(w, 80, iw, 1)
        assert isinstance(cw, CompactWire)
        assert cw.cache_rslot.dtype == np.uint16
        assert (cw.cache_rslot == RSLOT_NONE_U16).any()
        dev = wire_to_device(cw, "cpu")
        assert dev.cache_rslot.dtype == torch.int32
        assert (dev.cache_rslot == RSLOT_NONE_U16).any()    # widened -1
        got = expand_wire(dev, K, iw, 80)
        _assert_device_pack_equal(got, want, f"batch {i}")
        assert (got.nbr_rslot >= -1).all()
        jgot = jwire.expand_wire(
            jwire.CompactWire(**{f: None if a is None else jnp.asarray(a)
                                 for f, a in cw._asdict().items()}),
            K, iw, 80)
        np.testing.assert_array_equal(got.nbr_rslot.numpy(),
                                      np.asarray(jgot.nbr_rslot))


def _hand_wire(R=65_600, Ub=8, Ei=8, B=4, P=4):
    """A WirePack of R > 65,535 root slots built by hand, so that its
    compact form takes the i32 rslot encoding.  Rows 0..5 and 65,534..
    65,537 are valid; the rslot values include 65,535 and 65,536, the
    u16 sentinel and the first slot past u16."""
    N = 10
    r = np.random.default_rng(4)
    ev_src = np.array([1, 2, 3, 4], np.int32)
    ev_dst = np.array([5, 6, 7, 8], np.int32)
    ev_t = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    ev_idx = np.array([10, 11, 12, 13], np.int32)
    pw = np.arange(2 * B)
    valid = np.r_[np.arange(6), np.arange(65_534, 65_538)]
    root_loc = np.full(R, Ub - 1, np.int32)
    root_loc[valid] = r.integers(0, Ub - 1, len(valid))
    cache_loc = np.full((R, 2), Ub - 1, np.int32)
    cache_feat = np.full((R, 2), -1, np.int32)
    cache_dt = np.zeros((R, 2), np.float32)
    cache_rslot = np.full((R, 2), -1, np.int32)
    cache_loc[valid, 0] = r.integers(0, Ub - 1, len(valid))
    cache_feat[valid, 0] = r.integers(0, 9, len(valid))
    cache_dt[valid, 0] = r.uniform(0, 5, len(valid))
    cache_rslot[valid, 0] = [65_535, -1, 3, 65_536, 0, -1, 65_537, 5, -1,
                             65_535]
    ia_row = np.full(Ei, R, np.int32)
    ia_row[:5] = [0, 1, 65_534, 65_535, 65_535]
    ia_col = np.array([0, 0, 2, 0, 1, 0, 0, 0], np.int32)
    ia_loc = np.zeros(Ei, np.int32)
    ia_loc[:5] = [1, 2, 3, 4, 5]
    ia_feat = np.zeros(Ei, np.int32)
    ia_feat[:5] = [10, 11, 12, 13, 12]
    ia_dt = np.zeros(Ei, np.float32)
    ia_dt[:5] = [0.5, 1.5, 2.5, 3.5, 4.5]
    ia_rslot = np.full(Ei, -1, np.int32)
    ia_rslot[:5] = [65_536, -1, 65_535, 1, 65_599]
    wire = WirePack(
        ev_src=ev_src, ev_dst=ev_dst, ev_t=ev_t, ev_idx=ev_idx,
        ev_valid=np.ones(B, bool), ev_neg=np.array([0, 1, 2, 3], np.int32),
        ev_src_slot=np.array([0, 1, 2, 3], np.int32),
        ev_pos_slot=np.array([4, 5, 65_534, 65_535], np.int32),
        ev_neg_slot=np.array([0, 1, 65_536, 65_537], np.int32),
        uniq_nid=np.array([1, 2, 3, 4, 5, 6, 7, N], np.int32),
        root_loc=root_loc, cache_loc=cache_loc, cache_feat=cache_feat,
        cache_dt=cache_dt, self_dt=r.uniform(-3, 0, R).astype(np.float32),
        ia_row=ia_row, ia_col=ia_col, ia_loc=ia_loc, ia_feat=ia_feat,
        ia_dt=ia_dt,
        mw_node=np.where(pw & 1, ev_dst[pw >> 1], ev_src[pw >> 1]),
        mw_slot=np.zeros(2 * B, np.int32),
        mw_partner=np.where(pw & 1, ev_src[pw >> 1], ev_dst[pw >> 1]),
        mw_t=ev_t[pw >> 1], mw_eid=ev_idx[pw >> 1],
        cache_rslot=cache_rslot, ia_rslot=ia_rslot)
    self_col = np.where(root_loc != Ub - 1, np.arange(R), -1)
    intra = np.full((R, P), -1, np.int32)
    intra[ia_row[:5], ia_col[:5]] = ia_rslot[:5]
    want = np.concatenate([cache_rslot, self_col[:, None], intra], axis=1)
    return wire, want.astype(np.int32), N, P


def test_compact_wire_i32_carries_rslot_exactly():
    """The i32 encoding (R - 1 > 0xFFFE): rslot ships with -1, and slot
    65,535 stays a slot.  The expansion of the compact wire equals that
    of the plain WirePack in every field, its nbr_rslot equals the one
    built by hand, and the JAX expansion agrees."""
    wire, want, N, P = _hand_wire()
    cw = compact_wire(wire, N, P, 1)
    assert cw is not None and cw.cache_rslot.dtype == np.int32
    assert cw.ia_rslot.dtype == np.int32 and cw.root_loc.dtype == np.uint16
    got = expand_wire(wire_to_device(cw, "cpu"), 2, P, N)
    plain = expand_wire(wire_to_device(wire, "cpu"), 2, P, N)
    _assert_device_pack_equal(got, plain, "compact vs plain")
    np.testing.assert_array_equal(got.nbr_rslot.numpy(), want)
    assert (want == 65_535).sum() == 4
    jgot = jwire.expand_wire(
        jwire.CompactWire(**{f: None if a is None else jnp.asarray(a)
                             for f, a in cw._asdict().items()}), 2, P, N)
    np.testing.assert_array_equal(np.asarray(jgot.nbr_rslot), want)


# ------------------------------------------------------------------- model
def _pack(layers, M=1):
    """Three batches to fill the cache, then the pack under test (M > 1
    packs as an eval chunk)."""
    data = synthetic("tgbl-wiki-small", num_edges=500, num_nodes=60,
                     msg_dim=F, num_neg=M, seed=7)
    packer = StreamPacker(data.num_nodes, PackerConfig(
        num_neighbors=K, batch_size=80, max_intra_block=8, layers=layers))
    rng = np.random.default_rng(1)
    for i in range(4):
        rows = np.arange(80 * i, 80 * (i + 1))
        src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
        neg = rng.choice(data.unique_dst(), (80, M)).astype(np.int32)
        pack = packer.pack(src, dst, t, rows, get_block(src, dst),
                           neg[:, 0] if M == 1 else neg, eval_mode=M > 1)
    return data, pack


def _walk(port, want, path="", rtol=0.0, atol=0.0):
    """Two parameter trees (the port's through ``params_to_jax``, the JAX
    one) leaf by leaf: the same keys, values within the tolerances."""
    if isinstance(want, dict):
        assert port.keys() == want.keys(), path
        for k in want:
            _walk(port[k], want[k], f"{path}/{k}", rtol, atol)
        return
    np.testing.assert_allclose(port, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=path)


@pytest.mark.parametrize("memory", ["frozen", "local"])
@pytest.mark.parametrize("mode", ["scalar", "vector"])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_embed_and_grads_match_jax(layers, mode, memory):
    """The (R, D) embedding (eval) within TOL, and the loss of a train
    forward with every parameter's gradient (and, with ``local``, the
    memory rows') within GRAD_ATOL / GRAD_RTOL of JAX."""
    data, pack = _pack(layers)
    local = memory == "local"
    common = dict(edge_feat_dim=F, hidden_dim=D, num_heads=H,
                  num_layers=layers, message_mode=mode, feat_drop=0.0,
                  attn_drop=0.0, const_ones_memory=not local)
    jcfg, tcfg = JaxTGNNConfig(**common), TGNNConfig(**common)
    params = jax_init_tgnn(jax.random.PRNGKey(layers), jcfg)
    U = pack.uniq_nid.shape[0]
    rows = np.random.default_rng(8).normal(size=(U, D)).astype(np.float32)
    mem = rows if local else np.ones((data.num_nodes, D), np.float32)
    jpack, feats = pack.device(), jnp.asarray(data.msg)

    def jloss(p, m):
        pos, neg = jax_tgnn_forward(p, jcfg, m, feats, jpack, train=True,
                                    local=local)
        return jax_bce_loss(pos, neg, jpack.ev_valid)

    jl, (jgrads, jgmem) = jax.value_and_grad(jloss, argnums=(0, 1))(
        params, jnp.asarray(mem))
    jemb = jax_tgnn_embed(params, jcfg, jnp.asarray(mem), feats, jpack,
                          train=False, local=local)

    model = init_tgnn(tcfg)
    model.load_state_dict(params_from_jax(params))
    tpack = to_device(pack, "cpu")
    tmem = torch.from_numpy(mem).requires_grad_(local)
    tfeats = torch.from_numpy(data.msg)
    pos, neg = tgnn_forward(model, tcfg, tmem, tfeats, tpack, train=True,
                            local=local)
    loss = bce_loss(pos, neg, tpack.ev_valid)
    loss.backward()
    with torch.no_grad():
        emb = tgnn_embed(model, tcfg, tmem, tfeats, tpack, train=False,
                         local=local)
    assert emb.shape == (pack.root_nid.shape[0], D)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL, atol=TOL)
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    _walk(grads, jgrads, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if local:
        np.testing.assert_allclose(tmem.grad.numpy(), np.asarray(jgmem),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_embed_needs_rslot_above_one_layer():
    data, pack = _pack(1)
    cfg = TGNNConfig(edge_feat_dim=F, hidden_dim=D, num_heads=H,
                     num_layers=2, const_ones_memory=True)
    with pytest.raises(ValueError, match="nbr_rslot"):
        tgnn_embed(init_tgnn(cfg), cfg, None, torch.from_numpy(data.msg),
                   to_device(pack, "cpu"), train=False)


# ------------------------------------------------------------------ bridge
@pytest.mark.parametrize("layers", [2, 3])
def test_bridge_roundtrips_every_layer(layers):
    """``gat2`` … ``gat{L}`` of the JAX tree load into the port's
    submodules of the same names and come back exactly."""
    tree = jax_init_tgnn(jax.random.PRNGKey(5), JaxTGNNConfig(
        edge_feat_dim=F, hidden_dim=D, num_heads=H, num_layers=layers))
    state = params_from_jax(tree)
    assert {k.split(".")[0] for k in state} == {
        "time", "pred", "gat", *(f"gat{l}" for l in range(2, layers + 1))}
    model = init_tgnn(TGNNConfig(edge_feat_dim=F, hidden_dim=D, num_heads=H,
                                 num_layers=layers))
    model.load_state_dict(state)            # strict: names and shapes
    _walk(params_to_jax(model.state_dict()), tree)


# ------------------------------------------------------------------ engine
def _data(mod):
    return mod("tiny", num_edges=855, num_nodes=120, msg_dim=8, num_neg=8,
               seed=1)


BASE = dict(sampling=[dict(neighbor=[5])],
            gnn=[dict(att_head=4, dim_out=32, dim_time=32)],
            train=[dict(batch_size=100, lr=1e-3, dropout=0.0,
                        att_dropout=0.0, eval_neg_chunk=3)])


def _raw(gnn, memory):
    raw = dict(BASE, gnn=[dict(BASE["gnn"][0], **gnn)])
    if memory:
        raw = dict(raw, memory=[dict(dim_out=32, dim_time=32)],
                   train=[dict(BASE["train"][0], frozen_memory=False)])
    return raw


def _record(engine, losses, wires=None):
    step = engine._train_step

    def rec(*args):
        res = step(*args)
        losses.append(float(np.asarray(res[-4])) if isinstance(
            engine, JaxEngine) else float(res[0]))
        return res

    engine._train_step = rec
    if wires is not None:
        expand = engine._expand

        def spy(wire, iw):
            wires.append((type(wire).__name__,
                          getattr(wire, "cache_rslot", None) is not None))
            return expand(wire, iw)

        engine._expand = spy


def _lockstep(gnn, memory, jax_train, capsys):
    """Both engines from the same weights through one train epoch, the
    val pass and the test pass; the printed lines of each engine's passes
    are kept apart."""
    raw = _raw(gnn, memory)
    jraw = dict(raw, train=[dict(raw["train"][0], fuse_steps=1,
                                 **jax_train)])
    jeng = JaxEngine(_data(jax_synthetic), jax_config(jraw))
    peng = Engine(_data(synthetic), parse_config_dict(raw), device="cpu")
    peng.model.load_state_dict(params_from_jax(jeng.params))
    out = dict(jeng=jeng, peng=peng, jl=[], pl=[], wires=[])
    _record(jeng, out["jl"])
    _record(peng, out["pl"], out["wires"])
    out["jstats"], out["pstats"] = jeng.train_epoch(), peng.train_epoch()
    out["train_params"] = (params_to_jax(peng.model.state_dict()),
                           jax.tree.map(np.asarray, jeng.params))
    capsys.readouterr()
    for split in ("val", "test"):
        out[f"j_{split}"] = jeng.evaluate(split)
        out[f"j_{split}_log"] = capsys.readouterr().out
        out[f"p_{split}"] = peng.evaluate(split)
        out[f"p_{split}_log"] = capsys.readouterr().out
        out[f"p_{split}_protocol"] = peng.last_eval_trace["protocol"]
        out[f"{split}_packer"] = (peng.packer.snapshot(),
                                  jeng.packer.snapshot())
        if memory:
            # commit writes the port's state in place: keep a copy
            st = peng.mem_state
            out[f"{split}_state"] = (type(st)(*(x.clone() for x in st)),
                                     memory_state_from_jax(jeng.mem_state))
    return out


LOCKSTEPS = {
    "layer2_frozen": (dict(layer=2), False, {}),
    "layer2_memory": (dict(layer=2), True, {}),
    # the JAX "auto" gate closes on this stream; True makes both engines
    # take the slot-unique protocol
    "vector_frozen": (dict(message_mode="vector"), False,
                      dict(eval_slot_unique=True)),
    "vector_memory": (dict(message_mode="vector"), True,
                      dict(eval_slot_unique=True)),
}


@pytest.fixture(scope="module")
def runs():
    return {}


@pytest.fixture(params=sorted(LOCKSTEPS))
def run(request, runs):
    """Each lockstep once a module; capsys is function-scoped, so the
    first test of a case runs it under its own capture."""
    name = request.param
    if name not in runs:
        capsys = request.getfixturevalue("capsys")
        runs[name] = _lockstep(*LOCKSTEPS[name], capsys)
    return name, runs[name]


def test_engine_losses_match_per_step(run):
    name, r = run
    assert len(r["pl"]) == 6, name
    np.testing.assert_allclose(r["pl"], r["jl"], rtol=ENGINE_TOL,
                               atol=ENGINE_TOL, err_msg=name)
    for k in ("loss", "ap", "auc"):
        np.testing.assert_allclose(r["pstats"][k], r["jstats"][k],
                                   rtol=ENGINE_TOL, atol=ENGINE_TOL,
                                   err_msg=f"{name}: {k}")


def test_engine_params_match_after_the_epoch(run):
    name, r = run
    got, want = r["train_params"]
    assert ("gat2" in got) == ("layer2" in name)
    _walk(got, want, name, ENGINE_TOL, ENGINE_TOL)


@pytest.mark.parametrize("split", ["val", "test"])
def test_engine_eval_mrr_and_state_match(run, split):
    """MRR within MRR_TOL, the packer state equal, and with the memory
    every MemoryState field (mem within ENGINE_TOL, the rest exactly),
    after the val pass and after the test pass."""
    name, r = run
    pm, jm = r[f"p_{split}"], r[f"j_{split}"]
    assert 0.0 < pm <= 1.0 and abs(pm - jm) <= MRR_TOL, (name, pm, jm)
    for x, y in zip(*r[f"{split}_packer"]):
        np.testing.assert_array_equal(x, y, err_msg=name)
    if f"{split}_state" in r:
        got, want = r[f"{split}_state"]
        assert got.mail_valid.any()
        for f in want._fields:
            a, b = getattr(got, f).numpy(), getattr(want, f).numpy()
            if f == "mem":
                np.testing.assert_allclose(a, b, rtol=ENGINE_TOL,
                                           atol=ENGINE_TOL, err_msg=f)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_engine_protocol_and_wires(run):
    """At gnn.layer 2 every batch and chunk ships the compact wire with
    its rslot fields and the val pass takes column chunks, the port
    saying why (``gnn.layer>1``, JAX's gate string) once; the JAX Engine
    closes its gate too, on its first check (``_wire_dedup``, off at
    gnn.layer > 1).  Vector messages at one layer keep the dedup wire and
    the slot-unique protocol."""
    name, r = run
    kinds = set(r["wires"])
    if "layer2" in name:
        assert kinds == {("CompactWire", True)}, kinds
        assert r["p_val_protocol"] == r["p_test_protocol"] == "column_chunk"
        assert "slot-unique protocol off (gnn.layer>1)" in r["p_val_log"]
        assert "gnn.layer>1" not in r["p_test_log"]       # said once
        assert "slot-unique protocol off" in r["j_val_log"]
    else:
        assert kinds == {("DedupWire", False)}, kinds
        assert r["p_val_protocol"] == r["p_test_protocol"] == "slot_unique"
        assert "protocol off" not in r["p_val_log"] + r["j_val_log"]


def test_layer2_train_packs_on_the_main_thread():
    """At gnn.layer 2 the packer's worker is never given a job, and the
    synchronous packs land in ``fetch_s``."""
    eng = Engine(_data(synthetic), parse_config_dict(
        _raw(dict(layer=2), False)), device="cpu")
    submits = []
    real = eng.packer.pack_wire_dedup_submit
    eng.packer.pack_wire_dedup_submit = \
        lambda *a, **k: submits.append(1) or real(*a, **k)
    assert eng.train_epoch()["events"] == 599
    tr = eng.last_epoch_trace
    assert submits == [] and tr["batches"] == 6
    assert 0.0 < tr["fetch_s"] <= tr["pack_s"]


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("gnn,match", [
    (dict(layer=9), "gnn.layer"), (dict(layer=0), "gnn.layer"),
    (dict(message_mode="tensor"), "message_mode")],
    ids=["layer9", "layer0", "mode"])
def test_engine_refuses_out_of_range_model(gnn, match):
    with pytest.raises(ValueError, match=match):
        Engine(_data(synthetic), parse_config_dict(_raw(gnn, False)),
               device="cpu")


def test_two_layer_yml_parses_like_jax_and_builds():
    """The port's configs/TGN-2layer.yml holds the JAX package's values;
    Engine builds two attention layers, the GRU memory and a packer that
    emits rslot from it."""
    cfg = parse_config(ROOT / "tgb_tgn_dgl_tpu_torch/configs/TGN-2layer.yml")
    jcfg = jax_parse_config(ROOT / "tgb_tgn_dgl_tpu/configs/TGN-2layer.yml")
    for sec in ("sampling", "memory", "gnn", "train"):
        mine = dataclasses.asdict(getattr(cfg, sec))
        theirs = dataclasses.asdict(getattr(jcfg, sec))
        # DyGFormer's gnn keys are the port's alone
        only = set(PORT_ONLY_GNN_KEYS) if sec == "gnn" else set()
        assert set(mine) - set(theirs) == only, sec
        assert mine == {k: theirs.get(k, mine[k]) for k in mine}, sec
    assert cfg.gnn.layer == 2 and cfg.train.frozen_memory is False
    eng = Engine(_data(synthetic), cfg, device="cpu")
    assert eng.use_memory and eng.packer.cfg.layers == 2
    names = {n.split(".")[0] for n, _ in eng.model.named_parameters()}
    assert names == {"time", "gat", "gat2", "pred", "memory"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["layer2_memory", "vector_memory"])
def test_cuda_engine_matches_cpu(case):
    """The engine on the GPU (attention kernels at every layer) against
    the same engine on the CPU (plain versions), same weights, dropout 0:
    losses 1e-4, val MRR 1e-3, the MemoryState (mem 1e-4, the rest
    exact); the layer-2 run launches each kernel twice a step and twice a
    column chunk, the vector run none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tgb_tgn_dgl_tpu_torch.ops import attention
    gnn, memory, _ = LOCKSTEPS[case]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(_data(synthetic), parse_config_dict(_raw(gnn, memory)),
                     device=dev)
        losses = []
        _record(eng, losses)
        attention.reset_launch_counts()
        eng.train_epoch()
        mrr = eng.evaluate("val")
        out[dev] = (losses, mrr, eng.mem_state, dict(attention.launch_counts),
                    eng.last_eval_trace["chunks"])
    (lg, mg, sg, counts, chunks), (lc, mc, sc, _, _) = out["cuda"], out["cpu"]
    assert len(lg) == 6
    np.testing.assert_allclose(lg, lc, rtol=ENGINE_TOL, atol=ENGINE_TOL)
    assert abs(mg - mc) <= MRR_TOL, (mg, mc)
    for f in sc._fields:
        a, b = getattr(sg, f).cpu().numpy(), getattr(sc, f).numpy()
        if f == "mem":
            np.testing.assert_allclose(a, b, rtol=ENGINE_TOL,
                                       atol=ENGINE_TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    if case == "layer2_memory":
        assert counts == dict(attention_fwd=12, attention_bwd=12,
                              attention_fwd_drop=0, attention_bwd_drop=0,
                              attention_fwd_infer=2 * chunks)
    else:
        assert not any(counts.values()), counts
