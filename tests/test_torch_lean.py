"""Device-cache mode in the port (ops/lean_wire.py, data/lean_packer.py,
the Engine's ``train.device_cache``) on the CPU, against the JAX package:

  * the port's ``NativeLeanPacker`` against the JAX ``LeanPacker`` (numpy)
    and ``NativeLeanPacker``, every field of every wire exact, over train
    and eval batches with a self-loop and a repeated edge, a non-last eval
    chunk (``insert``/``write_mail`` False) and mailbox 1 and 2;
  * ``expand_lean`` and ``advance_stream`` against the JAX functions on
    the same wires, every DevicePack field and every state array exact,
    in train and eval mode, with a batch whose intra COO carries more
    padding entries than the intra width (padding columns past P);
  * ``expand_lean`` against ``to_device`` of the port's host
    ``StreamPacker`` pack, and the device state against the host packer's
    cache and clocks (JAX tests/test_lean.py:27);
  * an Engine lockstep, port device-cache against JAX device-cache from
    bridged weights at dropout 0, frozen and with the memory: epoch loss,
    AP, AUC and val MRR within the engine lockstep's TOL, ``sstate``
    exactly equal (and the memory state: ``mem`` within TOL, the rest
    exact).  The JAX Engine runs at its default ``fuse_steps`` (16): at
    ``fuse_steps`` 1 it advances the device state on every negative chunk
    of a batch, not on the last only (ROADMAP §3);
  * the port's device-cache engine against its host-pack engine at JAX
    tests/test_lean.py:119's tolerances;
  * the gate: JODIE, DyRep and two layers keep the host packer and say
    why; the slot-unique gate closes with "device_cache mode";
  * a run resumed from a device-cache checkpoint equals the uninterrupted
    run exactly, frozen and with the memory, its pack shapes included;
    ``snapshot_stream`` keeps a val pass out of training;
  * the lean read set's duplicate rows commit equal values;
  * on the GPU (``cuda``-marked, skipped here): the lean expansion and the
    state advance on the card against the CPU, and the GPU resume.
"""
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import TOL, _assert_mem_state_match
from test_torch_fit import _assert_trees_equal, _full_state_copy

from tgb_tgn_dgl_tpu.data.dataset import synthetic as jax_synthetic
from tgb_tgn_dgl_tpu.data.lean_packer import LeanPacker as JaxLeanPacker
from tgb_tgn_dgl_tpu.data.lean_packer import \
    NativeLeanPacker as JaxNativeLeanPacker
from tgb_tgn_dgl_tpu.data.packer import PackerConfig as JaxPackerConfig
from tgb_tgn_dgl_tpu.engine.train import Engine as JaxEngine
from tgb_tgn_dgl_tpu.ops import lean_wire as jlean
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.bridge import params_from_jax
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
from tgb_tgn_dgl_tpu_torch.data.lean_packer import NativeLeanPacker
from tgb_tgn_dgl_tpu_torch.data.packer import (DevicePack, PackerConfig,
                                               StreamPacker, to_device)
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.ops.lean_wire import (LeanWire, advance_stream,
                                                 expand_lean,
                                                 init_stream_device_state,
                                                 reset_stream_cache)
from tgb_tgn_dgl_tpu_torch.ops.wire import wire_to_device
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

K, B, CAP, M_EVAL = 4, 128, 8, 3
# DevicePack fields that must match the host pack exactly: the lean read
# set (uniq_nid, root_loc, nbr_loc) is the duplicated [roots ⊕ cache
# cells] by design
COMPARE = ["ev_src", "ev_dst", "ev_t", "ev_idx", "ev_valid", "ev_neg",
           "root_nid", "root_valid", "nbr_nid", "nbr_dt", "nbr_kind",
           "nbr_feat", "ev_src_slot", "ev_pos_slot", "ev_neg_slot",
           "mw_node", "mw_slot", "mw_partner", "mw_t", "mw_eid"]


def _stream_data(mod, seed=17):
    """900 events, 70 nodes, with a self-loop (row 10) and a repeated
    edge (row 11), as JAX tests/test_lean.py:162 builds them."""
    data = mod("lean-native", num_edges=900, num_nodes=70, msg_dim=5,
               num_neg=3, seed=seed)
    data.src[10] = data.dst[10]
    data.src[11], data.dst[11] = data.src[10], data.src[10]
    return data


def _jobs(data, S):
    """(batch, args, kw) of 6 batches: train, an eval batch as a non-last
    chunk (insert and write_mail False) and its last chunk, train again."""
    r = np.random.default_rng(5 + S)
    uniq = data.unique_dst()
    for bi in range(6):
        rows = np.arange(bi * B, (bi + 1) * B)
        src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
        blocks = get_block(src, dst)
        if bi == 3:
            neg = r.choice(uniq, (B, 2 * M_EVAL)).astype(np.int32)
            yield bi, (src, dst, t, rows, blocks, neg[:, :M_EVAL]), dict(
                eval_mode=True, insert=False, write_mail=False)
            yield bi, (src, dst, t, rows, blocks, neg[:, M_EVAL:]), dict(
                eval_mode=True)
        else:
            yield bi, (src, dst, t, rows, blocks,
                       r.choice(uniq, B).astype(np.int32)), {}


def _cfg(S, cls=PackerConfig):
    return cls(num_neighbors=K, batch_size=B, max_intra_block=CAP,
               mailbox_size=S)


def _assert_wires_equal(got, want, ctx):
    assert type(got)._fields == type(want)._fields, ctx
    for f in type(want)._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: {f}")


@pytest.mark.parametrize("S", [1, 2], ids=["mailbox1", "mailbox2"])
def test_native_lean_packer_matches_jax_packers(S):
    data = _stream_data(synthetic)
    port = NativeLeanPacker(data.num_nodes, _cfg(S))
    jnum = JaxLeanPacker(data.num_nodes, _cfg(S, JaxPackerConfig))
    jnat = JaxNativeLeanPacker(data.num_nodes, _cfg(S, JaxPackerConfig))
    for bi, args, kw in _jobs(data, S):
        wp, iwp = port.pack_wire(*args, **kw)
        assert isinstance(wp, LeanWire) and wp.wipe_final.shape == ()
        for name, jp in (("numpy", jnum), ("native", jnat)):
            wj, iwj = jp.pack_wire(*args, **kw)
            assert iwp == iwj
            _assert_wires_equal(wp, wj, f"batch {bi} {kw} vs JAX {name}")
        np.testing.assert_array_equal(port.mail_ptr, jnum.mail_ptr)
    assert port.mail_ptr.any() == (S > 1)
    assert port.bucket_state() == jnum._sticky
    snap = port.snapshot()
    port.reset_cache()
    assert not port.mail_ptr.any()
    port.restore(snap)
    np.testing.assert_array_equal(port.mail_ptr, jnum.mail_ptr)


def _jax_wire(wire):
    return jlean.LeanWire(*(jnp.asarray(a) for a in wire))


def _assert_state_matches_jax(got, want, ctx):
    pairs = [(got.cache.neighbors, want.cache.neighbors),
             (got.cache.e_id, want.cache.e_id), (got.cache.t, want.cache.t),
             (got.cache.cur_e_id, want.cache.cur_e_id),
             (got.clock, want.clock)]
    for i, (a, b) in enumerate(pairs):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, (ctx, i)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{ctx}: {i}")


@pytest.mark.parametrize("S", [1, 2], ids=["mailbox1", "mailbox2"])
def test_expand_and_advance_match_jax(S):
    data = _stream_data(synthetic, seed=13)
    N = data.num_nodes
    packer = NativeLeanPacker(N, _cfg(S))
    got = init_stream_device_state(N, K)
    want = jlean.init_stream_device_state(N, K)
    wide_padding = 0
    for bi, args, kw in _jobs(data, S):
        wire, iw = packer.pack_wire(*args, **kw)
        em = kw.get("eval_mode", False)
        nnz = int((wire.ia_row < wire.root_nid.shape[0]).sum())
        wide_padding += wire.ia_row.shape[0] - nnz > iw
        dw = wire_to_device(wire, "cpu")
        pack, nid = expand_lean(dw, got, K, iw, N, eval_mode=em,
                                batch_size=B)
        jpack, jnid = jlean.expand_lean(_jax_wire(wire), want, K, iw, N,
                                        eval_mode=em, batch_size=B)
        for f in DevicePack._fields:
            if getattr(jpack, f) is None:
                assert getattr(pack, f) is None, f
                continue
            a, b = getattr(pack, f).numpy(), np.asarray(getattr(jpack, f))
            assert a.dtype == b.dtype, (bi, f)
            np.testing.assert_array_equal(a, b, err_msg=f"batch {bi} {f}")
        assert torch.equal(nid, pack.uniq_nid)
        np.testing.assert_array_equal(nid.numpy(), np.asarray(jnid))
        if kw.get("insert", True):
            got = advance_stream(got, dw, N, eval_mode=em)
            want = jlean.advance_stream(want, _jax_wire(wire), N,
                                        eval_mode=em)
            _assert_state_matches_jax(got, want, f"batch {bi}")
    assert wide_padding, "no batch put its padding columns past P"
    got = reset_stream_cache(got)
    want = jlean.reset_stream_cache(want)
    _assert_state_matches_jax(got, want, "reset")


def test_expand_matches_the_host_pack():
    """JAX tests/test_lean.py:27 on the port: the lean expansion against
    the resident state equals to_device of the host packer's pack, and
    the device state equals the host packer's cache and clocks."""
    data = _stream_data(synthetic, seed=13)
    N = data.num_nodes
    host, lean = StreamPacker(N, _cfg(1)), NativeLeanPacker(N, _cfg(1))
    st = init_stream_device_state(N, K)
    for bi, args, kw in _jobs(data, 1):
        em = kw.get("eval_mode", False)
        want = to_device(host.pack(*args, **kw), "cpu")
        wire, iw = lean.pack_wire(*args, **kw)
        dw = wire_to_device(wire, "cpu")
        got, _ = expand_lean(dw, st, K, iw, N, eval_mode=em, batch_size=B)
        for f in COMPARE:
            assert torch.equal(getattr(got, f), getattr(want, f)), (bi, f)
        if kw.get("insert", True):
            st = advance_stream(st, dw, N, eval_mode=em)
            for a, b in ((st.cache.neighbors, host.cache_nbr),
                         (st.cache.e_id, host.cache_eid.astype(np.int32)),
                         (st.cache.t, host.cache_t), (st.clock, host.clock)):
                np.testing.assert_array_equal(a[:-1].numpy(), b,
                                              err_msg=f"batch {bi}")


# ----------------------------------------------------------------- Engine
RAW = dict(sampling=[dict(neighbor=[5])],
           gnn=[dict(att_head=2, dim_out=16, dim_time=16)],
           memory=[dict(dim_out=16, dim_time=16)],
           train=[dict(batch_size=100, lr=1e-3, dropout=0.0,
                       att_dropout=0.0, eval_neg_chunk=3,
                       device_cache=True)])


def _raw(frozen=True, **train):
    return dict(RAW, train=[dict(RAW["train"][0], frozen_memory=frozen,
                                 **train)])


def _data(mod):
    return mod("tiny", num_edges=855, num_nodes=120, msg_dim=8, num_neg=8,
               seed=1)


def _quiet(fn, *args, **kw):
    """fn's result and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue()


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "memory"])
def test_engine_matches_jax_device_cache(frozen):
    jeng = JaxEngine(_data(jax_synthetic), jax_config(_raw(frozen)))
    peng = Engine(_data(synthetic), parse_config_dict(_raw(frozen)),
                  device="cpu")
    assert jeng.device_cache and peng.device_cache
    assert isinstance(peng.packer, NativeLeanPacker)
    peng.model.load_state_dict(params_from_jax(jeng.params))
    js, ps = jeng.train_epoch(), peng.train_epoch()
    for k in ("loss", "ap", "auc"):
        np.testing.assert_allclose(ps[k], js[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert ps["events"] == js["events"]
    _assert_state_matches_jax(peng.sstate, jeng.sstate, "after training")
    jm = jeng.evaluate("val")
    pm, out = _quiet(peng.evaluate, "val")
    assert 0.0 < pm <= 1.0 and abs(pm - jm) <= TOL, (pm, jm)
    assert peng.last_eval_trace["protocol"] == "column_chunk"
    assert "slot-unique protocol off (device_cache mode)" in out
    _assert_state_matches_jax(peng.sstate, jeng.sstate, "after val")
    if not frozen:
        _assert_mem_state_match(peng, jeng, "after val")


def _run_port(raw):
    eng = Engine(_data(synthetic), parse_config_dict(raw), device="cpu")
    stats = eng.train_epoch()
    val, _ = _quiet(eng.evaluate, "val")
    return eng, stats, val


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "memory"])
def test_engine_matches_host_pack_engine(frozen):
    """JAX tests/test_lean.py:119 on the port: the same epoch and val MRR
    as the host packer's engine, and near-equal parameters (the lean read
    set repeats rows, so gradient sums may add in another order)."""
    e1, s1, v1 = _run_port(_raw(frozen, device_cache=False))
    e2, s2, v2 = _run_port(_raw(frozen))
    assert not e1.device_cache and e2.device_cache
    assert s1["events"] == s2["events"]
    np.testing.assert_allclose(s1["loss"], s2["loss"], rtol=1e-5)
    np.testing.assert_allclose(s1["ap"], s2["ap"], rtol=1e-4)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)
    for (k, a), b in zip(e1.model.state_dict().items(),
                         e2.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=1e-5, err_msg=k)
    nbr, eid, t, clock, _, _ = e1.packer.snapshot()
    np.testing.assert_array_equal(e2.sstate.cache.e_id[:-1].numpy(),
                                  eid.astype(np.int32))
    np.testing.assert_array_equal(e2.sstate.clock[:-1].numpy(), clock)


@pytest.mark.parametrize("gnn,reason", [
    (dict(arch="identity"), "gnn.arch!=transformer_attention"),
    (dict(arch="dyrep"), "gnn.arch!=transformer_attention"),
    (dict(layer=2), "gnn.layer>1")], ids=["jodie", "dyrep", "tgn_2layer"])
def test_gate_keeps_the_host_packer(gnn, reason):
    raw = dict(_raw(False), gnn=[dict(RAW["gnn"][0], **gnn)])
    eng, out = _quiet(Engine, _data(synthetic), parse_config_dict(raw),
                      device="cpu")
    assert not eng.device_cache and eng.sstate is None
    assert type(eng.packer).__name__ == "NativeStreamPacker"
    assert f"[train] device-cache mode off ({reason})" in out
    jeng = JaxEngine(_data(jax_synthetic), jax_config(raw))
    assert jeng.device_cache == eng.device_cache


def test_train_and_eval_trace_the_lean_pack():
    eng, _, _ = _run_port(_raw())
    tr, ev = eng.last_epoch_trace, eng.last_eval_trace
    assert tr["batches"] == 6 and tr["fetch_s"] > 0
    assert ev["protocol"] == "column_chunk" and ev["batches"] == 2
    assert ev["embed_chunks"] == 2 * 3
    assert eng._eval_gate_logged == {"device_cache mode"}


def _record_shapes(engine, out):
    """The shapes of every pack the engine expands from a lean wire."""
    expand = engine._expand_lean

    def wrapped(wire, iw, eval_mode):
        pack = expand(wire, iw, eval_mode)
        out.append(tuple(tuple(t.shape) for t in pack if t is not None))
        return pack

    engine._expand_lean = wrapped


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "memory"])
def test_resume_equals_uninterrupted(frozen, tmp_path):
    """At dropout 0.1 (the dropout generator resumes too): the resumed
    third epoch, its val pass, its pack shapes and the whole state at the
    end equal the uninterrupted run's."""
    raw = _raw(frozen, dropout=0.1, att_dropout=0.1, epoch=3)

    def engine():
        return Engine(_data(synthetic), parse_config_dict(raw), device="cpu")

    whole, shapes_w, shapes_r = engine(), [], []
    _record_shapes(whole, shapes_w)
    hw, _ = _quiet(whole.fit, epochs=3, log=lambda s: None,
                   checkpoint_dir=str(tmp_path), checkpoint_every=1)
    saved = torch.load(tmp_path / "ckpt_epoch0002.pt", weights_only=True)
    assert set(saved["sstate"]) == {"neighbors", "e_id", "t", "cur_e_id",
                                    "clock"}
    assert set(saved["packer"]) == {"mail_ptr", "buckets"}
    assert {(1, False), (3, True)} <= set(saved["packer"]["buckets"])
    resumed = engine()
    resumed.load_checkpoint(str(tmp_path / "ckpt_epoch0002.pt"))
    assert resumed.packer.bucket_state() == saved["packer"]["buckets"]
    _record_shapes(resumed, shapes_r)
    hr, _ = _quiet(resumed.fit, epochs=1, log=lambda s: None)
    assert shapes_r == shapes_w[-len(shapes_r):]
    assert hr["loss"] == hw["loss"][2:] and hr["val"] == hw["val"][2:]
    _assert_trees_equal(_full_state_copy(resumed), _full_state_copy(whole))


def test_val_snapshot_protects_training():
    """The device-cache case of JAX tests/test_engine.py:251-286: with a
    snapshot around the val pass, epoch 2 gives the loss of a run that
    never validated and the device clocks come back bit-equal; without it
    the val pass advances them."""
    def clocks(eng):
        return eng.sstate.clock.clone()

    def run(with_val, snapshot):
        eng = Engine(_data(synthetic), parse_config_dict(_raw()),
                     device="cpu")
        eng.train_epoch()
        pre = clocks(eng)
        if with_val:
            snap = eng.snapshot_stream() if snapshot else None
            _quiet(eng.evaluate, "val")
            if snap is not None:
                eng.restore_stream(snap)
        mutated = not torch.equal(pre, clocks(eng))
        return eng.train_epoch()["loss"], mutated

    base, _ = run(False, False)
    protected, prot_mut = run(True, True)
    _, unprot_mut = run(True, False)
    assert protected == base and not prot_mut and unprot_mut


def test_lean_read_set_duplicates_commit_equal_rows():
    """``commit`` writes each read-set row at its node: in the lean read
    set a node stands once as a root and again in every cache cell that
    holds it, and each copy carries the same applied row, so the write
    order cannot matter; only the trash row N collides with other values,
    and it is zeroed after."""
    eng = Engine(_data(synthetic), parse_config_dict(_raw(False)),
                 device="cpu")
    eng.config.train.sanity_batches = 2
    eng.train_epoch()                 # mail pending, a cache to read
    seen = []
    apply = eng._apply_mail

    def spy(pack):
        rows, lu = apply(pack)
        seen.append((pack.uniq_nid.clone(), rows.detach(), lu.detach()))
        return rows, lu

    eng._apply_mail = spy
    eng.config.train.sanity_batches = 3
    eng.train_epoch()
    N = eng.data.num_nodes
    dup_nodes = 0
    for nid, rows, lu in seen:
        for node in torch.unique(nid):
            at = (nid == node).nonzero()[:, 0]
            if len(at) < 2 or int(node) == N:
                continue
            dup_nodes += 1
            assert (rows[at] == rows[at[0]]).all()
            assert (lu[at] == lu[at[0]]).all()
    assert dup_nodes > 0
    assert not eng.mem_state.mem[N].any()


# ------------------------------------------------------------------- GPU
@pytest.mark.cuda
def test_cuda_lean_expansion_and_advance_match_cpu():
    """The lean expansion and the state advance on the card equal the CPU
    run exactly, field by field (no atomics: every scatter's duplicates
    carry equal values or land on a trash row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = _stream_data(synthetic, seed=13)
    N = data.num_nodes
    packer = NativeLeanPacker(N, _cfg(2))
    st = {d: init_stream_device_state(N, K, d) for d in ("cpu", "cuda")}
    for bi, args, kw in _jobs(data, 2):
        wire, iw = packer.pack_wire(*args, **kw)
        em = kw.get("eval_mode", False)
        out = {}
        for d in st:
            dw = wire_to_device(wire, d)
            out[d] = expand_lean(dw, st[d], K, iw, N, eval_mode=em,
                                 batch_size=B)[0]
            if kw.get("insert", True):
                st[d] = advance_stream(st[d], dw, N, eval_mode=em)
        for f in DevicePack._fields:
            a, b = getattr(out["cuda"], f), getattr(out["cpu"], f)
            assert (a is None and b is None) or torch.equal(a.cpu(), b), f
        for a, b in zip((*st["cuda"].cache, st["cuda"].clock),
                        (*st["cpu"].cache, st["cpu"].clock)):
            assert torch.equal(a.cpu(), b), bi


@pytest.mark.cuda
def test_cuda_resume_matches_uninterrupted(tmp_path):
    """On the GPU with the memory at dropout 0.1: a device-cache run
    resumed from its epoch-1 checkpoint gives the uninterrupted run's
    epoch-2 loss, val MRR and device state exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    raw = _raw(False, dropout=0.1, att_dropout=0.1)

    def engine():
        return Engine(_data(synthetic), parse_config_dict(raw))

    whole = engine()
    hw, _ = _quiet(whole.fit, epochs=2, log=lambda s: None,
                   val_snapshot=True, checkpoint_dir=str(tmp_path),
                   checkpoint_every=1)
    resumed = engine()
    resumed.load_checkpoint(str(tmp_path / "ckpt_epoch0001.pt"))
    hr, _ = _quiet(resumed.fit, epochs=1, log=lambda s: None,
                   val_snapshot=True)
    assert hr["loss"] == hw["loss"][1:] and hr["val"] == hw["val"][1:]
    for a, b in zip((*resumed.sstate.cache, resumed.sstate.clock),
                    (*whole.sstate.cache, whole.sstate.clock)):
        assert torch.equal(a, b)
