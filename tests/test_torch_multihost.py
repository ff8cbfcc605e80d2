"""The port's multi-host primitives (tgb_tgn_dgl_tpu_torch/parallel/
multihost.py, owned_state.py, ops/wire.py::stack_wires) against the JAX
package's on the same numpy inputs, on the CPU:

  * ``partition_super_batch``, ``_encode``/``_decode``: equal outputs;
  * ``SuperBatchExchanger`` over the port's numpy and native packers at
    N in {2, 3} hosts and mailbox S in {1, 2}: after every super-batch
    each host's packer state is a serial packer's, exactly;
  * ``replan_mail_slots``: JAX's plans and a serial packer's write plans,
    exactly;
  * ``apply_mail_plan``, ``offset_wire_for_host``, ``pad_wire_ei``,
    ``concat_offset_wires``, ``stack_wires`` on the native packer's wires
    of one super-batch: every field equal to the JAX function's;
  * the three composed steps (frozen, the mailbox memory for TGN and
    JODIE, DyRep's eager memory) against the JAX step functions from the
    same bridged weights over two super-batches at dropout 0: loss, pos/neg
    logits, the parameters after Adam and the memory state within the
    engine lockstep's TOL (tests/test_torch_engine.py);
  * the owned state: ``NativeNodeRangeOwnedState`` equal to
    ``NodeRangeOwnedState`` and to the JAX package's, their rows equal to
    a serial packer's; the rows API of the native packer equal to the
    numpy packer's; ``pack_with_gathered_state`` equal to the pack on the
    whole serial state; ``restore_serial_from_owners`` giving the serial
    state back.
"""
import jax
import numpy as np
import pytest

from test_torch_engine import TOL
from tgb_tgn_dgl_tpu.data.dataset import synthetic as jax_synthetic
from tgb_tgn_dgl_tpu.engine.train import Engine as JaxEngine
from tgb_tgn_dgl_tpu.ops.wire import WirePack as JaxWirePack
from tgb_tgn_dgl_tpu.ops.wire import stack_wires as jax_stack_wires
from tgb_tgn_dgl_tpu.parallel import multihost as jmh
from tgb_tgn_dgl_tpu.parallel.mh_engine import \
    build_composed_frozen_step as jax_frozen_step
from tgb_tgn_dgl_tpu.parallel.owned_state import \
    NodeRangeOwnedState as JaxOwned
from tgb_tgn_dgl_tpu.parallel.owned_state import gather_rows as jax_gather
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.bridge import params_from_jax, params_to_jax
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig, StreamPacker
from tgb_tgn_dgl_tpu_torch.engine.negatives import NegLinkSamplerDest
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.ops.wire import stack_wires, wire_to_device
from tgb_tgn_dgl_tpu_torch.parallel import multihost as pmh
from tgb_tgn_dgl_tpu_torch.parallel.mh_engine import \
    build_composed_frozen_step
from tgb_tgn_dgl_tpu_torch.parallel.owned_state import (
    NativeNodeRangeOwnedState, NodeRangeOwnedState, gather_rows,
    pack_with_gathered_state, restore_serial_from_owners)
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

STATE = ("cache_nbr", "cache_eid", "cache_t", "clock", "mail_ptr")


def _assert_state_equal(a, b, ctx=""):
    for f in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{ctx}: {f}")
    assert a.cur_e_id == b.cur_e_id, ctx


def _assert_wires_equal(a, b, ctx=""):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, (ctx, f)
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: {f}")


# ------------------------------------------------------------- partition
@pytest.mark.parametrize("lo,hi,n,B", [(0, 400, 2, 200), (200, 500, 3, 100),
                                       (0, 130, 4, 50), (7, 7, 2, 10)])
def test_partition_super_batch_matches_jax(lo, hi, n, B):
    mine = pmh.partition_super_batch(lo, hi, n, B)
    theirs = jmh.partition_super_batch(lo, hi, n, B)
    assert [(r.lo, r.hi, r.host) for r in mine] == [
        (r.lo, r.hi, r.host) for r in theirs]


def test_partition_super_batch_refuses_an_oversized_range():
    with pytest.raises(ValueError, match="larger than"):
        pmh.partition_super_batch(0, 401, 2, 200)


@pytest.mark.parametrize("B,M", [(0, 1), (5, 1), (7, 3)])
def test_encode_decode_match_jax(B, M):
    rng = np.random.default_rng(B + M)
    src = rng.integers(0, 100, B).astype(np.int32)
    dst = rng.integers(0, 100, B).astype(np.int32)
    t = rng.random(B).astype(np.float32) * 1e6
    idx = np.arange(B, dtype=np.int64) + 40
    neg = rng.integers(0, 100, (B, M)).astype(np.int32)
    buf = pmh._encode(src, dst, t, idx, neg if M > 1 else neg[:, 0])
    np.testing.assert_array_equal(
        buf, jmh._encode(src, dst, t, idx, neg if M > 1 else neg[:, 0]))
    if B == 0:
        return
    for a, b in zip(pmh._decode(buf), jmh._decode(buf)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    dsrc, ddst, dt, didx, dneg = pmh._decode(buf)
    np.testing.assert_array_equal(dt, t)
    np.testing.assert_array_equal(dneg, neg)


# --------------------------------------------------------------- exchange
def _packer(impl, N, cfg):
    return (NativeStreamPacker if impl == "native" else StreamPacker)(N, cfg)


@pytest.mark.parametrize("impl", ["numpy", "native"])
@pytest.mark.parametrize("n_hosts,mailbox", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_super_batch_exchange_matches_serial(n_hosts, mailbox, impl):
    """Each host packs its range against the super-batch's start state;
    after the exchange every host's state is the serial packer's, the
    native packer's too, whose clock and ring pointers are copies that
    the exchanger writes back through load_state."""
    data = synthetic("mh", num_edges=1400, num_nodes=200, msg_dim=4,
                     num_neg=4, seed=9)
    B = 100
    rows = np.nonzero(data.train_mask)[0]
    cfg = PackerConfig(num_neighbors=5, batch_size=B, mailbox_size=mailbox)
    serial = _packer(impl, data.num_nodes, cfg)
    hosts = [_packer(impl, data.num_nodes, cfg) for _ in range(n_hosts)]
    neg_sampler = NegLinkSamplerDest(data.unique_dst(), seed=3)
    sb = n_hosts * B
    for lo in range(0, len(rows), sb):
        ranges = pmh.partition_super_batch(lo, min(lo + sb, len(rows)),
                                           n_hosts, B)
        batches = []
        for r in ranges:
            idx = rows[r.lo:r.hi]
            src, dst, t = data.src[idx], data.dst[idx], data.t[idx]
            neg = (neg_sampler.sample(dst) if len(idx)
                   else np.zeros(0, np.int32))
            batches.append((src, dst, t, idx, neg))
            if len(idx):
                blk = get_block(src, dst)
                hosts[r.host].pack(src, dst, t, idx, blk, neg)
                serial.pack(src, dst, t, idx, blk, neg)
        payloads = [pmh._encode(*b) for b in batches]
        for h in range(n_hosts):
            pmh.SuperBatchExchanger(hosts[h], h, n_hosts,
                                    allgather=lambda _p: payloads
                                    ).exchange(*batches[h])
        for h in range(n_hosts):
            _assert_state_equal(hosts[h], serial, f"sb {lo} host {h}")


def test_exchange_refuses_a_missing_range():
    cfg = PackerConfig(num_neighbors=5, batch_size=10)
    ex = pmh.SuperBatchExchanger(StreamPacker(20, cfg), 0, 2)
    e = np.zeros(0, np.int32)
    with pytest.raises(ValueError, match="expected 2 ranges"):
        ex.exchange(e, e, e.astype(np.float32), e, e)


# ----------------------------------------------------------------- replan
@pytest.mark.parametrize("S", [1, 2, 3])
def test_replan_mail_slots_matches_jax_and_serial_packer(S):
    data = synthetic("replan", num_edges=1200, num_nodes=150, msg_dim=4,
                     num_neg=1, seed=13)
    B, n_hosts = 100, 3
    cfg = PackerConfig(num_neighbors=5, batch_size=B, mailbox_size=S)
    serial = StreamPacker(data.num_nodes, cfg)
    rng = np.random.default_rng(0)
    for lo in range(0, 1200, n_hosts * B):
        ptr0 = serial.mail_ptr.copy()
        srcs, dsts, want = [], [], []
        for h in range(n_hosts):
            rows = np.arange(lo + h * B, lo + (h + 1) * B)
            src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
            neg = rng.integers(0, data.num_nodes, B).astype(np.int32)
            pack = serial.pack(src, dst, t, rows, get_block(src, dst), neg)
            srcs.append(src)
            dsts.append(dst)
            want.append(np.where(pack.mw_node == data.num_nodes, -1,
                                 pack.mw_slot).astype(np.int64))
        plans, ptr_end = pmh.replan_mail_slots(srcs, dsts, ptr0, S, B)
        jplans, jptr_end = jmh.replan_mail_slots(srcs, dsts, ptr0, S, B)
        for h in range(n_hosts):
            np.testing.assert_array_equal(plans[h], want[h])
            np.testing.assert_array_equal(plans[h], jplans[h])
        np.testing.assert_array_equal(ptr_end, serial.mail_ptr)
        np.testing.assert_array_equal(ptr_end, jptr_end)


# ------------------------------------------------------------ composition
TINY = dict(
    sampling=[dict(neighbor=[5])],
    memory=[dict(dim_out=16, dim_time=16, mailbox_size=2)],
    gnn=[dict(dim_out=16, att_head=2, dim_time=16)],
    train=[dict(batch_size=64, lr=1e-3, dropout=0.0, att_dropout=0.0,
                max_intra_block=8, frozen_memory=False, seed=5)],
)


def _tiny_data(mod):
    return mod("mh-compose", num_edges=800, num_nodes=120, msg_dim=6,
               num_neg=2, seed=29)


def _raw(arch="transformer_attention", frozen=False, **memory):
    train = dict(TINY["train"][0], frozen_memory=frozen)
    mem = dict(TINY["memory"][0], **memory)
    if arch == "identity":
        mem["memory_update"] = "rnn"
    return dict(TINY, gnn=[dict(TINY["gnn"][0], arch=arch)], train=[train],
                memory=[mem])


def _super_batches(eng, n_hosts, count):
    """The port engine's first ``count`` super-batches of ``n_hosts``
    ranges, packed as MultiHostEngine packs them (each range from the
    super-batch's start state, then the exchange): a list of (wires,
    batches, start ring pointers)."""
    eng.warm_buckets()
    d, B = eng.data, eng.config.train.batch_size
    rows_all, blocks = eng._rows["train"], eng.blocks_for("train")
    out = []
    for s in range(count):
        snap = eng.packer.snapshot()
        wires, batches = [], []
        for r in pmh.partition_super_batch(s * n_hosts * B,
                                           (s + 1) * n_hosts * B, n_hosts,
                                           B):
            idx = rows_all[r.lo:r.hi]
            src, dst, t = d.src[idx], d.dst[idx], d.t[idx]
            neg = eng.neg_sampler.sample(dst)
            eng.packer.restore(snap)
            wires.append(eng.packer.pack_wire(src, dst, t, idx,
                                              blocks[r.lo:r.hi], neg)[0])
            batches.append((src, dst, t, idx, neg))
        eng.packer.restore(snap)
        payloads = [pmh._encode(*b) for b in batches]
        pmh.SuperBatchExchanger(eng.packer, -1, n_hosts,
                                allgather=lambda _p: payloads
                                ).exchange(*batches[0])
        out.append((wires, batches, snap[5].copy()))
    return out


def _jax_wire(wire):
    return JaxWirePack(**wire._asdict())


def test_wire_composition_matches_jax():
    eng = Engine(_tiny_data(synthetic), parse_config_dict(_raw()),
                 device="cpu")
    N, S = eng.data.num_nodes, 2
    (wires, batches, ptr0), = _super_batches(eng, 3, 1)
    plans, _ = pmh.replan_mail_slots([b[0] for b in batches],
                                     [b[1] for b in batches], ptr0, S, 64)
    for h, (w, pl) in enumerate(zip(wires, plans)):
        _assert_wires_equal(pmh.apply_mail_plan(w, pl, N),
                            jmh.apply_mail_plan(w, pl, N), f"plan {h}")
        _assert_wires_equal(pmh.offset_wire_for_host(w, h, 3),
                            jmh.offset_wire_for_host(w, h, 3), f"off {h}")
        Ei = 2 * w.ia_row.shape[0]
        _assert_wires_equal(pmh.pad_wire_ei(w, Ei), jmh.pad_wire_ei(w, Ei),
                            f"pad {h}")
    for mail_plans in (None, plans):
        _assert_wires_equal(
            pmh.concat_offset_wires(wires, mail_plans, N),
            jmh.concat_offset_wires(wires, mail_plans, N),
            f"concat plans={mail_plans is not None}")
    aligned = pmh.align_wires(wires)
    _assert_wires_equal(stack_wires(aligned), jax_stack_wires(aligned),
                        "stack")
    assert stack_wires(aligned).uniq_nid.shape == (
        3, *wires[0].uniq_nid.shape)


def test_compose_refuses_ranges_in_other_buckets():
    eng = Engine(_tiny_data(synthetic), parse_config_dict(_raw()),
                 device="cpu")
    (wires, _, _), = _super_batches(eng, 2, 1)
    big = wires[1]._replace(root_loc=np.concatenate(
        [wires[1].root_loc, wires[1].root_loc]))
    with pytest.raises(ValueError, match="root_loc"):
        pmh.concat_offset_wires([wires[0], big])
    with pytest.raises(ValueError, match="over"):
        pmh.pad_wire_ei(wires[0], wires[0].ia_row.shape[0] - 1)


# ----------------------------------------------------------- composed steps
def _assert_params_close(jparams, model, ctx):
    """Every JAX leaf against the port's parameter of its name."""
    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=f"{ctx}: {path}")

    walk(params_to_jax(model.state_dict()), jparams, "")


def _assert_memory_close(jstate, pstate, ctx):
    for f, a, b in zip(pstate._fields, jstate, pstate):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                       err_msg=f"{ctx}: {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{ctx}: {f}")


@pytest.mark.parametrize("arch,frozen", [
    ("transformer_attention", True), ("transformer_attention", False),
    ("identity", False), ("dyrep", False)])
def test_composed_step_matches_jax(arch, frozen):
    """Two super-batches of 2 ranges through the port's composed step and
    the JAX one, from the same weights (the JAX Engine's, bridged)."""
    raw = _raw(arch, frozen)
    jeng = JaxEngine(_tiny_data(jax_synthetic), jax_config(raw))
    peng = Engine(_tiny_data(synthetic), parse_config_dict(raw),
                  device="cpu")
    peng.model.load_state_dict(params_from_jax(jeng.params))
    n, N, K, IW = 2, peng.data.num_nodes, 5, 8
    S = peng.config.memory.mailbox_size
    eager = arch == "dyrep"
    if frozen:
        jstep = jax_frozen_step(jeng.model_cfg, jeng.optimizer, K, IW, N)
        pstep = build_composed_frozen_step(peng.model, peng.model_cfg,
                                           peng.optimizer, K, IW, N,
                                           generator=peng.generator)
    elif eager:
        jstep = jmh.build_composed_dyrep_step(
            jeng.model_cfg, jeng.mem_cfg, jeng.optimizer, K, IW, N, n)
        pstep = pmh.build_composed_dyrep_step(
            peng.model, peng.model_cfg, peng.mem_cfg, peng.optimizer, K, IW,
            N, n, generator=peng.generator)
    else:
        jstep = jmh.build_composed_memory_step(
            jeng.model_cfg, jeng.mem_cfg, jeng.optimizer, K, IW, N, n,
            arch=arch)
        pstep = pmh.build_composed_memory_step(
            peng.model, peng.model_cfg, peng.mem_cfg, peng.optimizer, K, IW,
            N, n, arch=arch, generator=peng.generator)
    params, opt_state, jmem = jeng.params, jeng.opt_state, jeng.mem_state
    key = jax.random.PRNGKey(0)
    for s, (wires, batches, ptr0) in enumerate(_super_batches(peng, n, 2)):
        if frozen:
            gw = pmh.concat_offset_wires(wires)
            params, opt_state, jl, jp, jn = jstep(
                params, opt_state, jeng.memory, jeng.feats, _jax_wire(gw),
                key)
            pl, pp, pn = pstep(peng.feats, wire_to_device(gw, "cpu"))
        else:
            plans, _ = pmh.replan_mail_slots(
                [b[0] for b in batches], [b[1] for b in batches], ptr0, S,
                64)
            if eager:
                gw = stack_wires(pmh.align_wires(
                    [pmh.apply_mail_plan(w, pl, N)
                     for w, pl in zip(wires, plans)]))
            else:
                gw = pmh.concat_offset_wires(wires, plans, N)
            params, opt_state, jmem, jl, jp, jn = jstep(
                params, opt_state, jmem, jeng.feats, _jax_wire(gw), key)
            peng.mem_state, pl, pp, pn = pstep(peng.mem_state, peng.feats,
                                               wire_to_device(gw, "cpu"))
            _assert_memory_close(jmem, peng.mem_state, f"sb {s} memory")
        np.testing.assert_allclose(float(pl), float(jl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=TOL,
                                   atol=TOL)
        _assert_params_close(params, peng.model, f"sb {s} {arch}")


# ------------------------------------------------------------ owned state
def _owned_stream(seed=4):
    data = synthetic("owned", num_edges=900, num_nodes=90, msg_dim=4,
                     num_neg=4, seed=seed)
    rng = np.random.default_rng(seed)
    B = 60
    out = []
    for lo in range(0, 600, B):
        rows = np.arange(lo, lo + B)
        src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
        neg = rng.integers(0, data.num_nodes, B).astype(np.int32)
        out.append((src, dst, t, rows, get_block(src, dst), neg, False))
    rows = np.arange(600, 660)                 # an eval batch, M = 3
    src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
    neg = rng.integers(0, data.num_nodes, (60, 3)).astype(np.int32)
    out.append((src, dst, t, rows, get_block(src, dst), neg, True))
    return data, out


@pytest.mark.parametrize("S", [1, 2])
def test_owned_state_matches_numpy_jax_and_serial(S):
    """Every batch through 3 owners of each kind: the native owners'
    state equals the numpy owners' and the JAX owners', and the owned
    rows equal the serial packer's; the gather equals JAX's, bytes
    included."""
    data, stream = _owned_stream()
    N, K, n = data.num_nodes, 5, 3
    kinds = {"native": [NativeNodeRangeOwnedState(N, n, h, K, S)
                        for h in range(n)],
             "numpy": [NodeRangeOwnedState(N, n, h, K, S) for h in range(n)],
             "jax": [JaxOwned(N, n, h, K, S) for h in range(n)]}
    serial = NativeStreamPacker(N, PackerConfig(num_neighbors=K,
                                                batch_size=60,
                                                mailbox_size=S))
    nodes = np.random.default_rng(1).permutation(N)[:50]
    for i, (src, dst, t, rows, blk, neg, ev) in enumerate(stream):
        serial.pack_wire(src, dst, t, rows, blk, neg, eval_mode=ev)
        for owners in kinds.values():
            for ow in owners:
                ow.apply_batch(src, dst, t, blk, neg, e_id=rows,
                               eval_mode=ev)
        for h in range(n):
            sl = slice(kinds["numpy"][h].lo, kinds["numpy"][h].hi)
            for f in STATE:
                want = np.asarray(getattr(serial, f))[sl]
                for name, owners in kinds.items():
                    np.testing.assert_array_equal(
                        getattr(owners[h], f), want,
                        err_msg=f"batch {i} {name} host {h} {f}")
            assert (kinds["native"][h].merge_entries
                    == kinds["numpy"][h].merge_entries)
        got = gather_rows(kinds["native"], nodes)
        for a, b in zip(got, jax_gather(kinds["jax"], nodes)):
            np.testing.assert_array_equal(a, b)


def test_rows_api_matches_the_numpy_packer():
    """set_rows / set_clock_rows / set_mail_rows / clear_rows on the
    native packer and on the numpy packer: equal state, and equal packs
    read from it."""
    data, stream = _owned_stream(seed=6)
    N = data.num_nodes
    cfg = PackerConfig(num_neighbors=5, batch_size=60, mailbox_size=2)
    nat, ref = NativeStreamPacker(N, cfg), StreamPacker(N, cfg)
    for p in (nat, ref):
        assert p.rows_api_available()
        for src, dst, t, rows, blk, neg, _ in stream[:3]:
            p.pack(src, dst, t, rows, blk, neg)
    rng = np.random.default_rng(2)
    nodes = rng.permutation(N)[:20].astype(np.int64)
    nbr = rng.integers(0, N, (20, 5)).astype(np.int32)
    eid = rng.integers(-1, 500, (20, 5)).astype(np.int64)
    tt = rng.random((20, 5)).astype(np.float32)
    clock = rng.random(20).astype(np.float32)
    ptr = rng.integers(0, 2, 20).astype(np.int64)
    others = np.setdiff1d(np.arange(N), nodes)[:5]
    for p in (nat, ref):
        p.set_rows(nodes, nbr, eid, tt, clock)
        p.set_clock_rows(others, clock[:5] * 2)
        p.set_mail_rows(nodes, ptr)
    _assert_state_equal(nat, ref, "after set")
    src, dst, t, rows, blk, neg, _ = stream[4]
    a = nat.pack(src, dst, t, rows, blk, neg, insert=False)
    b = ref.pack(src, dst, t, rows, blk, neg, insert=False)
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f)
    for zero_all in (False, True):
        for p in (nat, ref):
            p.clear_rows(nodes[:10 + 5 * zero_all], zero_all_clocks=zero_all)
        _assert_state_equal(nat, ref, f"after clear {zero_all}")


@pytest.mark.parametrize("owner_cls", [NodeRangeOwnedState,
                                       NativeNodeRangeOwnedState])
def test_pack_with_gathered_state_matches_the_serial_pack(owner_cls):
    """Each batch packed on a scratch packer from boundary-gathered rows
    equals the serial packer's pack in every field; the scratch is left
    as a fresh packer; the serial state rebuilt from the owners equals
    the serial packer's."""
    data, stream = _owned_stream(seed=8)
    N, K, S, n = data.num_nodes, 5, 2, 3
    cfg = PackerConfig(num_neighbors=K, batch_size=60, max_intra_block=8,
                       mailbox_size=S)
    serial = NativeStreamPacker(N, cfg)
    scratch = NativeStreamPacker(N, cfg)
    scratch._sticky = serial._sticky
    owners = [owner_cls(N, n, h, K, S) for h in range(n)]
    fresh = NativeStreamPacker(N, cfg).snapshot()
    for i, (src, dst, t, rows, blk, neg, ev) in enumerate(stream):
        want, iw = serial.pack_wire(src, dst, t, rows, blk, neg,
                                    eval_mode=ev)
        got, iw2, nbytes = pack_with_gathered_state(
            scratch, owners, src, dst, t, rows, blk, neg, eval_mode=ev)
        assert iw2 == iw and nbytes > 0
        _assert_wires_equal(got, want, f"batch {i}")
        for a, b in zip(scratch.snapshot(), fresh):
            np.testing.assert_array_equal(a, b)
        for ow in owners:
            ow.apply_batch(src, dst, t, blk, neg, e_id=rows, eval_mode=ev)
    for target in (NativeStreamPacker(N, cfg), StreamPacker(N, cfg)):
        restore_serial_from_owners(target, owners)
        _assert_state_equal(target, serial, type(target).__name__)


def test_native_state_views_are_copies_written_back_by_load_state():
    cfg = PackerConfig(num_neighbors=5, batch_size=10)
    p = NativeStreamPacker(30, cfg)
    p.insert(np.arange(5, dtype=np.int32), np.arange(5, 10, dtype=np.int32),
             np.ones(5, np.float32))
    clock = p.clock
    clock[:] = 7.0
    assert not np.any(p.clock == 7.0)
    p.load_state(p.cache_nbr, p.cache_eid, p.cache_t, clock, p.cur_e_id,
                 p.mail_ptr + 1)
    np.testing.assert_array_equal(p.clock, np.full(30, 7.0, np.float32))
    np.testing.assert_array_equal(p.mail_ptr, np.ones(30, np.int64))
    assert p.cur_e_id == 5

