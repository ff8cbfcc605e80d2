"""The port's Engine against the JAX Engine in lockstep on a tiny
synthetic stream: batch 100, 4 heads, dim 32, dropout 0, the same
(bridged) initial weights.  One train epoch is 6 Adam steps (599 train
events); then a streaming val pass with 8 negatives in chunks of 3, so
the column-chunk protocol's state advance on the last chunk is exercised
(``eval_slot_unique: False`` in the JAX Engine, ``_evaluate_chunked`` in
the port's).  One more lockstep runs the val pass at each engine's
default: the JAX ``"auto"`` gate closes on this stream and takes column
chunks, the port's gate opens and takes the slot-unique protocol.
Both with the frozen all-ones memory and with the mailbox memory
(``frozen_memory: False``, GRU, one slot), where every ``MemoryState``
field is compared too: ``mem`` within 1e-4, the rest exactly.  Both
engines pack with their native packer and ship dedup wires (eval-lean at
eval).  A third lockstep runs the compact wire: the JAX Engine with
``wire_dedup: False`` against the port's Engine with a packer that hands
every batch back, as a batch with an intra window over 255 is handed
back, so the port packs each batch again into a compact wire; and one
real batch with a hub in 280 of its 300 events takes that fallback in
both engines.

Tolerances: per-step loss and every parameter within 1e-4 abs+rel after 6
steps (fp32 both sides; Adam divides by sqrt(v) and so amplifies the
last-bit differences of small gradients); val MRR within 1e-3, since a
rank can flip on a near-tie."""
import itertools

import numpy as np
import pytest

import torch

from tgb_tgn_dgl_tpu.data.dataset import synthetic
from tgb_tgn_dgl_tpu.data.native_packer import \
    NativeStreamPacker as JaxNativePacker
from tgb_tgn_dgl_tpu.engine.train import Engine as JaxEngine
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.bridge import (memory_state_from_jax,
                                          params_from_jax, params_to_jax)
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic as port_synthetic
from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig, StreamPacker
from tgb_tgn_dgl_tpu_torch.engine.negatives import NegLinkSamplerDest
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

TOL = 1e-4
MRR_TOL = 1e-3
RAW = dict(
    sampling=[dict(neighbor=[5])],
    gnn=[dict(att_head=4, dim_out=32, dim_time=32)],
    train=[dict(batch_size=100, lr=1e-3, dropout=0.0, att_dropout=0.0,
                eval_neg_chunk=3)],
)
JAX_ONLY = dict(fuse_steps=1, eval_slot_unique=False)
MEMORY = dict(frozen_memory=False)


def _data(mod):
    return mod("tiny", num_edges=855, num_nodes=120, msg_dim=8, num_neg=8,
               seed=1)


def _record_losses(engine, out):
    step = engine._train_step

    def wrapped(*args):
        res = step(*args)
        out.append(float(np.asarray(res[-4])) if isinstance(engine, JaxEngine)
                   else float(res[0]))
        return res

    engine._train_step = wrapped


def _record_wires(engine, out):
    """Each wire the port's engine expands, as (type, eval-lean)."""
    expand = engine._expand

    def wrapped(wire, iw):
        out.append((type(wire).__name__,
                    getattr(wire, "cache_dt", 0) is None))
        return expand(wire, iw)

    engine._expand = wrapped


def _with_train(raw, **train):
    return dict(raw, train=[dict(raw["train"][0], **train)])


class _HandsBack:
    """The port's packer as if every batch had an intra window over 255:
    submit takes the batch and packs nothing, fetch hands it back, so the
    Engine packs each batch again on its own thread (``_pack_wire``)."""

    def __init__(self, packer):
        self._packer = packer

    def pack_wire_dedup_submit(self, *args, **kw):
        return True

    def pack_wire_dedup_fetch(self):
        return None

    def __getattr__(self, name):
        return getattr(self._packer, name)


def _run_lockstep(raw, jax_only=JAX_ONLY, wrap_packer=None, data=_data):
    jeng = JaxEngine(data(synthetic), jax_config(_with_train(raw,
                                                            **jax_only)))
    peng = Engine(data(port_synthetic), parse_config_dict(raw),
                  device="cpu")
    if wrap_packer is not None:
        peng.packer = wrap_packer(peng.packer)
    peng.model.load_state_dict(params_from_jax(jeng.params))
    jl, pl, wires = [], [], []
    _record_losses(jeng, jl)
    _record_losses(peng, pl)
    _record_wires(peng, wires)
    jstats = jeng.train_epoch()
    pstats = peng.train_epoch()
    jstats = {k: jstats[k] for k in jstats.keys()}
    return dict(jeng=jeng, peng=peng, jl=jl, pl=pl, jstats=jstats,
                pstats=pstats, wires=wires)


@pytest.fixture(scope="module")
def lockstep():
    return _run_lockstep(RAW)


def _memory_raw(**train):
    return dict(_with_train(RAW, **MEMORY, **train),
                memory=[dict(dim_out=32, dim_time=32)])


@pytest.fixture(scope="module")
def memory_lockstep():
    """The mailbox-memory engines after the train epoch; the val pass is
    run by ``test_memory_val_mrr_and_state_match``."""
    return _run_lockstep(_memory_raw())


def _assert_losses_match(lockstep):
    assert len(lockstep["pl"]) == 6
    np.testing.assert_allclose(lockstep["pl"], lockstep["jl"], rtol=TOL,
                               atol=TOL)
    for k in ("loss", "ap", "auc"):
        np.testing.assert_allclose(lockstep["pstats"][k],
                                   lockstep["jstats"][k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert lockstep["pstats"]["events"] == lockstep["jstats"]["events"]


def test_losses_match_per_step(lockstep):
    _assert_losses_match(lockstep)


def _assert_params_match(lockstep):
    got = params_to_jax(lockstep["peng"].model.state_dict())

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=path)

    walk(got, lockstep["jeng"].params, "")
    assert got.keys() == lockstep["jeng"].params.keys()


def test_params_match_after_six_steps(lockstep):
    _assert_params_match(lockstep)


def _assert_mem_state_match(peng, jeng, when):
    got, want = peng.mem_state, memory_state_from_jax(jeng.mem_state)
    for f in want._fields:
        a, b = getattr(got, f).cpu().numpy(), getattr(want, f).numpy()
        assert a.dtype == b.dtype, (when, f)
        if f == "mem":
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=f"{when}: {f}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{when}: {f}")


def test_memory_losses_match_per_step(memory_lockstep):
    _assert_losses_match(memory_lockstep)


def test_memory_params_match_after_six_steps(memory_lockstep):
    assert "memory" in memory_lockstep["jeng"].params
    _assert_params_match(memory_lockstep)


def test_memory_state_matches_after_epoch(memory_lockstep):
    st = memory_lockstep["peng"].mem_state
    assert st.mail_valid.any() and st.mem.abs().max() > 0
    _assert_mem_state_match(memory_lockstep["peng"], memory_lockstep["jeng"],
                            "after the train epoch")


def test_memory_val_mrr_and_state_match(memory_lockstep):
    jeng, peng = memory_lockstep["jeng"], memory_lockstep["peng"]
    jm = jeng.evaluate("val")
    pm = peng._evaluate_chunked("val")
    assert 0.0 < pm <= 1.0
    assert abs(pm - jm) <= MRR_TOL, (pm, jm)
    _assert_mem_state_match(peng, jeng, "after the val pass")


def test_memory_epoch_restarts_from_zero_state(memory_lockstep):
    """A second train epoch starts from a reset state: its first step's
    read set sees no mail, so every read row is zero."""
    eng = Engine(_data(port_synthetic),
                 parse_config_dict(_memory_raw(sanity_batches=1)),
                 device="cpu")
    eng.model.load_state_dict(memory_lockstep["peng"].model.state_dict())
    eng.mem_state = memory_lockstep["peng"].mem_state
    seen = []
    apply = eng._apply_mail

    def spy(pack):
        rows, lu = apply(pack)
        seen.append((rows.abs().max().item(), lu.abs().max().item()))
        return rows, lu

    eng._apply_mail = spy
    eng.train_epoch()
    assert seen == [(0.0, 0.0)]


@pytest.mark.cuda
def test_cuda_memory_engine_matches_cpu():
    """The mailbox-memory engine on the GPU (attention kernels) against
    the same engine on the CPU (plain versions), same weights, dropout 0:
    losses 1e-4, val MRR 1e-3, the MemoryState (mem 1e-4, the rest
    exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tgb_tgn_dgl_tpu_torch.ops import attention
    out = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(_data(port_synthetic), parse_config_dict(_memory_raw()),
                     device=dev)
        losses = []
        _record_losses(eng, losses)
        attention.reset_launch_counts()
        eng.train_epoch()
        mrr = eng.evaluate("val")
        out[dev] = (losses, mrr, eng.mem_state, dict(attention.launch_counts))
    (lg, mg, sg, counts), (lc, mc, sc, _) = out["cuda"], out["cpu"]
    assert len(lg) == 6
    np.testing.assert_allclose(lg, lc, rtol=TOL, atol=TOL)
    assert abs(mg - mc) <= MRR_TOL, (mg, mc)
    for f in sc._fields:
        a, b = getattr(sg, f).cpu().numpy(), getattr(sc, f).numpy()
        if f == "mem":
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for name in ("attention_fwd", "attention_bwd", "attention_fwd_infer"):
        assert counts[name] > 0, name


def _assert_val_mrr_matches(lockstep, chunked=True):
    """The val pass of both engines: the port's by column chunks, or with
    ``chunked=False`` by its default protocol."""
    jm = lockstep["jeng"].evaluate("val")
    peng = lockstep["peng"]
    pm = peng._evaluate_chunked("val") if chunked else peng.evaluate("val")
    assert 0.0 < pm <= 1.0
    assert abs(pm - jm) <= MRR_TOL, (pm, jm)
    # the stream state advanced identically through the pass
    for a, b in zip(lockstep["peng"].packer.snapshot(),
                    lockstep["jeng"].packer.snapshot()):
        np.testing.assert_array_equal(a, b)


def test_val_mrr_matches(lockstep):
    _assert_val_mrr_matches(lockstep)
    assert lockstep["peng"].last_eval_trace["protocol"] == "column_chunk"


def test_auto_val_mrr_matches(capsys):
    """Each engine's default val pass: the JAX ``"auto"`` gate estimates a
    per-block dedup of 1.14x on this stream, under its 1.5x, says so and
    takes column chunks; the port's gate, which has no dedup estimate,
    opens and takes the slot-unique protocol.  They agree as above."""
    run = _run_lockstep(RAW, jax_only=dict(fuse_steps=1))
    unique = run["jeng"]._evaluate_unique
    calls = []
    run["jeng"]._evaluate_unique = lambda *a: calls.append(a[0]) or unique(*a)
    capsys.readouterr()
    _assert_val_mrr_matches(run, chunked=False)
    assert calls == []
    assert run["peng"].last_eval_trace["protocol"] == "slot_unique"
    logged = [l for l in capsys.readouterr().out.splitlines()
              if "slot-unique protocol off" in l]
    assert len(logged) == 1
    assert "dedup 1.14x < 1.5x at N=120" in logged[0]


def test_both_engines_pack_natively_and_ship_dedup_wires(lockstep):
    """The JAX Engine's default transport, on both sides: the native
    packer one batch ahead, dedup wires in training, eval-lean dedup wires
    at eval (recorded here from the val pass of ``test_val_mrr_matches``
    or run now)."""
    jeng, peng = lockstep["jeng"], lockstep["peng"]
    assert isinstance(jeng.packer, JaxNativePacker) and jeng._wire_dedup
    assert isinstance(peng.packer, NativeStreamPacker)
    assert lockstep["wires"][:6] == [("DedupWire", False)] * 6
    if len(lockstep["wires"]) == 6:
        peng._evaluate_chunked("val")
    assert set(lockstep["wires"][6:]) == {("DedupWire", True)}
    assert peng.last_eval_trace["chunks"] == len(lockstep["wires"]) - 6
    # the packer's fetch and the copy are parts of getting the next wire
    for tr in (peng.last_epoch_trace, peng.last_eval_trace):
        assert tr["fetch_s"] > 0.0 and tr["copy_s"] > 0.0
        assert tr["fetch_s"] + tr["copy_s"] <= tr["pack_s"] <= tr["total_s"]


@pytest.fixture(scope="module")
def compact_lockstep():
    return _run_lockstep(RAW, dict(JAX_ONLY, wire_dedup=False), _HandsBack)


def test_compact_wire_losses_match_per_step(compact_lockstep):
    assert compact_lockstep["wires"] == [("CompactWire", False)] * 6
    _assert_losses_match(compact_lockstep)


def test_compact_wire_params_match_after_six_steps(compact_lockstep):
    _assert_params_match(compact_lockstep)


def test_compact_wire_val_mrr_matches(compact_lockstep):
    _assert_val_mrr_matches(compact_lockstep)
    assert set(compact_lockstep["wires"][6:]) == {("CompactWire", False)}


def _hub_data(mod):
    """The tiny stream with one source in 280 of the first 300 events:
    the intra window of its root slot is 279, over the dedup wire's 255."""
    import dataclasses
    data = _data(mod)
    src = data.src.copy()
    src[:280] = src[0]
    return dataclasses.replace(data, src=src)


def test_wide_intra_window_batch_takes_the_compact_wire():
    """A real batch the dedup wire cannot carry: both engines pack it again
    on their main thread into a compact wire, and the step agrees."""
    raw = _with_train(RAW, batch_size=300, max_intra_block=None,
                      sanity_batches=1)
    run = _run_lockstep(raw, data=_hub_data)
    assert run["wires"] == [("CompactWire", False)]
    assert len(run["pl"]) == 1
    np.testing.assert_allclose(run["pl"], run["jl"], rtol=TOL, atol=TOL)
    _assert_params_match(run)


def test_sanity_batches_pack_no_batch_past_the_limit():
    """After ``sanity_batches=2`` the pack-ahead has packed exactly the two
    batches: the stream state equals a numpy packer fed those two."""
    data = _data(port_synthetic)
    raw = _with_train(RAW, sanity_batches=2, max_intra_block=8)
    eng = Engine(data, parse_config_dict(raw), device="cpu")
    assert eng.train_epoch()["events"] == 200
    ref = StreamPacker(data.num_nodes, PackerConfig(
        num_neighbors=5, batch_size=100, max_intra_block=8))
    sampler = NegLinkSamplerDest(data.unique_dst(), seed=0)
    for _, _, rows, blk in itertools.islice(eng._iter_batches("train"), 2):
        dst = data.dst[rows]
        ref.pack(data.src[rows], dst, data.t[rows], rows, blk,
                 sampler.sample(dst))
    for a, b in zip(eng.packer.snapshot(), ref.snapshot()):
        np.testing.assert_array_equal(a, b)
    assert eng.packer.cur_e_id == 200


@pytest.mark.cuda
def test_cuda_expansion_matches_cpu():
    """Wires copied to the GPU and expanded there equal the same wires
    expanded on the CPU, field by field and exactly: dedup train wires,
    eval-lean wires, and the compact wire."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tgb_tgn_dgl_tpu_torch.data.dependency import dependency_aware_batch
    from tgb_tgn_dgl_tpu_torch.ops.wire import (compact_wire,
                                                eval_lean_dedup, expand_any,
                                                nb_bucket_of, wire_to_device)
    data = _data(port_synthetic)
    N, B = data.num_nodes, 100
    cfg = PackerConfig(num_neighbors=5, batch_size=B, max_intra_block=32)
    dedup = NativeStreamPacker(N, cfg)
    plain = NativeStreamPacker(N, cfg)
    times = torch.from_numpy(data.t.astype(np.float32))
    blocks = dependency_aware_batch(data.src, data.dst, B)
    rng = np.random.default_rng(0)
    for bi, lo in enumerate(range(0, 500, B)):
        rows = np.arange(lo, lo + B)
        em = bi >= 3
        neg = rng.integers(0, N, (B, 8) if em else B).astype(np.int32)
        args = (data.src[rows], data.dst[rows], data.t[rows], rows,
                blocks[rows], neg)
        w, P = dedup.pack_wire_dedup(*args, eval_mode=em)
        if em:
            w = eval_lean_dedup(w, blocks[rows], nb_bucket_of(blocks))
        pw, pP = plain.pack_wire(*args, eval_mode=em)
        for wire, iw in ((w, P), (compact_wire(pw, N, pP, 1), pP)):
            got = expand_any(wire_to_device(wire, "cuda"), 5, iw, N,
                             times.cuda())
            want = expand_any(wire_to_device(wire, "cpu"), 5, iw, N, times)
            for f in want._fields:
                if getattr(want, f) is None:    # nbr_rslot at one layer
                    assert getattr(got, f) is None, (bi, f)
                    continue
                a, b = getattr(got, f).cpu(), getattr(want, f)
                assert a.dtype == b.dtype and torch.equal(a, b), (bi, f)


def test_engine_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(_data(port_synthetic), parse_config_dict(RAW))


def test_memory_yml_parses_like_jax_and_builds():
    """The port's configs/TGN-memory.yml holds the JAX package's values;
    Engine builds the GRU memory from it (GRU input 2D + F + D_t) and,
    without a GPU, refuses to run unless asked for the CPU."""
    import dataclasses
    from pathlib import Path
    from tgb_tgn_dgl_tpu.utils.config import parse_config as jax_parse
    from tgb_tgn_dgl_tpu_torch.utils.config import (PORT_ONLY_GNN_KEYS,
                                                    parse_config)
    root = Path(__file__).resolve().parents[1]
    cfg = parse_config(root / "tgb_tgn_dgl_tpu_torch/configs/TGN-memory.yml")
    jcfg = jax_parse(root / "tgb_tgn_dgl_tpu/configs/TGN-memory.yml")
    for sec in ("sampling", "memory", "gnn", "train"):
        mine = dataclasses.asdict(getattr(cfg, sec))
        theirs = dataclasses.asdict(getattr(jcfg, sec))
        # DyGFormer's gnn keys are the port's alone
        only = set(PORT_ONLY_GNN_KEYS) if sec == "gnn" else set()
        assert set(mine) - set(theirs) == only, sec
        assert mine == {k: theirs.get(k, mine[k]) for k in mine}, sec
    assert cfg.train.frozen_memory is False
    data = _data(port_synthetic)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(data, cfg)
    eng = Engine(data, cfg, device="cpu")
    assert eng.use_memory and eng.mem_cfg.msg_dim == 2 * 100 + 8 + 100
    assert tuple(eng.model.memory.cell.w_ih.shape) == (308, 300)
    assert eng.mem_state.mem.shape == (data.num_nodes + 1, 100)
    assert any(n.startswith("memory.cell.") for n, _ in
               eng.model.named_parameters())


def test_sanity_batches_and_unknown_keys():
    raw = dict(RAW, train=[dict(RAW["train"][0], sanity_batches=2)])
    eng = Engine(_data(port_synthetic), parse_config_dict(raw), device="cpu")
    assert eng.train_epoch()["events"] == 200
    with pytest.raises(ValueError, match="fuse_steps"):
        parse_config_dict(dict(train=[dict(fuse_steps=4)]))
