"""The 'uniform' sampling strategy of the port against the JAX package, on
the CPU, with the same seeded numpy inputs on both sides.

  * The host library (csrc/hostops.cpp through data/hostops.py) and the
    numpy reference of data/tcsr.py and data/dependency.py: ``build_tcsr``,
    ``sample`` ('recent' and 'uniform') and the leveler bit-equal to their
    JAX counterparts, the C++ ones to JAX's C++ ones and the numpy ones to
    JAX's numpy ones (JAX's C++ probe switched off by monkeypatch), since
    the numpy 'uniform' draws come from ``default_rng`` and the C++ ones
    from a splitmix64 stream: two functions of the seed.
  * The numpy ``StreamPacker`` with a t-CSR: ``pack`` and ``pack_wire``
    bit-equal to JAX's on train batches and on eval batches with 8
    negatives, the packer's draw stream included.
  * The port's Engine against the JAX Engine under 'uniform' at dropout 0,
    frozen and with the mailbox memory (the bridged weights, the tiny
    stream of tests/test_torch_engine.py): per-step loss and parameters
    within ``TOL`` = 1e-4, then the val pass, where both gates close with
    "wire_dedup off or strategy!=recent" and take column chunks: MRR
    within ``MRR_TOL`` = 1e-3 and the packer state after it equal.
  * ``warm_buckets``' table equals JAX's, and the probe leaves the
    engine's draws alone; a run resumed from a checkpoint equals the
    uninterrupted one (the checkpoint holds the packer's draw stream,
    which JAX's leaves out); a val snapshot does not rewind the draws (as
    in JAX).
  * The parallel engines refuse 'uniform' (the JAX ones sample 'recent'
    whatever the strategy says)."""
import numpy as np
import pytest
import torch

from test_torch_engine import (MRR_TOL, TOL, _assert_mem_state_match,
                               _assert_params_match, _data, _memory_raw,
                               _run_lockstep)

import tgb_tgn_dgl_tpu.data.dependency as jax_dependency
import tgb_tgn_dgl_tpu.data.hostops as jax_hostops
import tgb_tgn_dgl_tpu.data.tcsr as jax_tcsr
from tgb_tgn_dgl_tpu.data.dataset import synthetic as jax_synthetic
from tgb_tgn_dgl_tpu.data.packer import PackerConfig as JaxPackerConfig
from tgb_tgn_dgl_tpu.data.packer import StreamPacker as JaxStreamPacker
from tgb_tgn_dgl_tpu.engine.train import Engine as JaxEngine
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.data import tcsr
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.dependency import (check_block_invariants,
                                                   dependency_aware_batch)
from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig, StreamPacker
from tgb_tgn_dgl_tpu_torch.engine.train import UNIFORM_GATE, Engine
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

RAW = dict(
    sampling=[dict(neighbor=[5], strategy="uniform")],
    gnn=[dict(att_head=4, dim_out=32, dim_time=32)],
    train=[dict(batch_size=100, lr=1e-3, dropout=0.0, att_dropout=0.0,
                eval_neg_chunk=3, seed=5)],
)
B = 100


@pytest.fixture(scope="module", autouse=True)
def jax_cpp():
    """The JAX package's C++ library built and loaded in this process: its
    C++ paths are what the port's C++ paths are held to.  A probe made
    before the build caches "absent" (then JAX's samplers would take numpy
    draws): only then is the probe made again, since a second load of a
    loaded library would drop the entry points other JAX modules declared
    on it."""
    assert jax_tcsr.build_if_needed()
    if not jax_hostops.available():
        jax_hostops._SEARCHED = False
    assert jax_hostops.available()


@pytest.fixture(scope="module")
def stream():
    """The tiny stream (numpy arrays, identical in both packages)."""
    return _data(synthetic)


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's numpy paths: its C++ probe reports no library."""
    monkeypatch.setattr(jax_tcsr, "build_if_needed", lambda: False)
    monkeypatch.setattr(jax_hostops, "available", lambda: False)


def _jax_impl(impl, request):
    if impl == "numpy":
        request.getfixturevalue("jax_numpy")


# ------------------------------------------------------- t-CSR, samplers
@pytest.mark.parametrize("impl", ["cpp", "numpy"])
def test_build_tcsr_matches_jax(impl, stream, request, tmp_path):
    _jax_impl(impl, request)
    got = tcsr.build_tcsr(stream.src, stream.dst, stream.t,
                          stream.num_nodes, impl=impl)
    want = jax_tcsr.build_tcsr(stream.src, stream.dst, stream.t,
                               stream.num_nodes)
    for f in tcsr.TCSR._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert len(got.indices) == 2 * len(stream.src)
    got.save_npz(str(tmp_path / "ext_full.npz"))
    back = tcsr.TCSR.load_npz(str(tmp_path / "ext_full.npz"))
    assert all(np.array_equal(a, b) for a, b in zip(back, got))


@pytest.mark.parametrize("strategy", ["recent", "uniform"])
@pytest.mark.parametrize("impl", ["cpp", "numpy"])
def test_sample_matches_jax(impl, strategy, stream, request):
    """400 queries at seeded nodes and times (many with no history before
    their time), K = 7, seed 11; the C++ draws repeat at any thread
    count."""
    _jax_impl(impl, request)
    g = tcsr.build_tcsr(stream.src, stream.dst, stream.t, stream.num_nodes)
    rng = np.random.default_rng(3)
    nodes = rng.integers(0, stream.num_nodes, 400).astype(np.int32)
    times = rng.uniform(0, stream.t.max() * 1.1, 400).astype(np.float32)
    got = tcsr.sample(g, nodes, times, 7, strategy=strategy, seed=11,
                      impl=impl)
    want = jax_tcsr.sample(jax_tcsr.TCSR(*g), nodes, times, 7,
                           strategy=strategy, seed=11)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (got[1] >= 0).any() and (got[1] < 0).any()
    # every sampled edge is older than its query
    ok = got[1] >= 0
    assert (got[2][ok] < np.repeat(times, 7).reshape(-1, 7)[ok]).all()
    if impl == "cpp":
        again = tcsr.sample(g, nodes, times, 7, strategy=strategy, seed=11,
                            num_threads=1)
        assert all(np.array_equal(a, b) for a, b in zip(again, got))


def test_cpp_and_numpy_uniform_draws_are_other_functions(stream):
    """Both draw from the same histories, from other streams."""
    g = tcsr.build_tcsr(stream.src, stream.dst, stream.t, stream.num_nodes)
    nodes = np.arange(stream.num_nodes, dtype=np.int32)
    times = np.full(stream.num_nodes, stream.t.max() + 1, np.float32)
    c = tcsr.sample(g, nodes, times, 5, strategy="uniform", seed=2)
    n = tcsr.sample(g, nodes, times, 5, strategy="uniform", seed=2,
                    impl="numpy")
    assert np.array_equal(c[1] >= 0, n[1] >= 0)
    assert not np.array_equal(c[1], n[1])
    with pytest.raises(ValueError, match="impl"):
        tcsr.sample(g, nodes, times, 5, impl="python")
    with pytest.raises(ValueError, match="strategy"):
        tcsr.sample(g, nodes, times, 5, strategy="latest")


def test_cpp_refuses_node_ids_out_of_range(stream):
    """The C++ indexes by node id unchecked: the bindings check first."""
    g = tcsr.build_tcsr(stream.src, stream.dst, stream.t, stream.num_nodes)
    with pytest.raises(ValueError, match="node ids"):
        tcsr.sample(g, [stream.num_nodes], [1.0], 3)
    with pytest.raises(ValueError, match="node ids"):
        tcsr.build_tcsr(stream.src, stream.dst, stream.t,
                        int(stream.dst.max()))


@pytest.mark.parametrize("impl", ["cpp", "numpy"])
def test_leveler_matches_jax(impl, stream, request):
    """The split's blocks at batch 100 and 37, against the JAX leveler of
    the same kind."""
    _jax_impl(impl, request)
    for bs in (B, 37):
        got = dependency_aware_batch(stream.src, stream.dst, bs, impl=impl)
        want = jax_dependency.dependency_aware_batch(stream.src, stream.dst,
                                                     bs)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        check_block_invariants(stream.src, stream.dst, got, bs)


def test_engine_levels_with_the_configured_thread_count(monkeypatch):
    """``sampling.num_thread`` reaches the C++ leveler, as in the JAX
    Engine, and the blocks do not depend on it."""
    import tgb_tgn_dgl_tpu_torch.data.dependency as dependency
    seen = []
    leveler = dependency.hostops.dependency_blocks

    def spy(src, dst, batch_size, num_threads=None):
        seen.append(num_threads)
        return leveler(src, dst, batch_size, num_threads)

    monkeypatch.setattr(dependency.hostops, "dependency_blocks", spy)
    raw = dict(RAW, sampling=[dict(RAW["sampling"][0], num_thread=3)])
    eng = Engine(_data(synthetic), parse_config_dict(raw), device="cpu")
    blocks = eng.blocks_for("train")
    assert seen == [3]
    rows = eng._rows["train"]
    one = dependency_aware_batch(eng.data.src[rows], eng.data.dst[rows], B,
                                 num_threads=1)
    assert np.array_equal(blocks, one)


def test_check_block_invariants_raises_on_a_planted_violation(stream):
    src, dst = stream.src[:B], stream.dst[:B]
    blocks = dependency_aware_batch(src, dst, B)
    assert not (src == dst).any()
    check_block_invariants(src, dst, blocks, B)
    # an event that shares a node with an earlier one moved into its block
    i = next(i for i in range(1, B) if blocks[i] > 0)
    bad = blocks.copy()
    bad[i] = next(blocks[j] for j in range(i) if {src[j], dst[j]}
                  & {src[i], dst[i]})
    with pytest.raises(AssertionError, match="invariant violated"):
        check_block_invariants(src, dst, bad, B)


# ---------------------------------------------------------------- packer
def test_uniform_packer_matches_jax(stream):
    """Six train batches and three eval batches (8 negatives each; the
    middle one packed as a column chunk that inserts nothing), ``pack``
    and ``pack_wire`` in turn: every field, the intra width, the sticky
    table, the stream state and the next draw equal JAX's."""
    kw = dict(num_neighbors=5, batch_size=B, max_intra_block=8,
              strategy="uniform", seed=7)
    jp = JaxStreamPacker(stream.num_nodes, JaxPackerConfig(**kw))
    pp = StreamPacker(stream.num_nodes, PackerConfig(**kw))
    g = tcsr.build_tcsr(stream.src, stream.dst, stream.t, stream.num_nodes)
    jp.set_tcsr(jax_tcsr.TCSR(*g))
    pp.set_tcsr(g)
    blocks = dependency_aware_batch(stream.src, stream.dst, B)
    rng = np.random.default_rng(0)
    wires = 0
    for i, lo in enumerate(range(0, 900, B)):
        rows = np.arange(lo, min(lo + B, len(stream.src)))
        em = i >= 6
        neg = rng.integers(0, stream.num_nodes,
                           (len(rows), 8) if em else len(rows))
        args = (stream.src[rows], stream.dst[rows], stream.t[rows], rows,
                blocks[rows], neg.astype(np.int32))
        kw = dict(eval_mode=em, insert=i != 7, write_mail=i != 7)
        if i % 2:
            (a, ia), (b, ib) = jp.pack_wire(*args, **kw), \
                pp.pack_wire(*args, **kw)
            assert ia == ib
            wires += 1
        else:
            a, b = jp.pack(*args, **kw), pp.pack(*args, **kw)
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), (i, f)
            if x is not None:
                assert np.asarray(x).dtype == np.asarray(y).dtype, (i, f)
                assert np.array_equal(x, y), (i, f)
    assert wires == 4
    assert pp.bucket_state() == jp._sticky
    assert {(1, False), (8, True)} <= set(jp._sticky)
    for x, y in zip(pp.snapshot(), jp.snapshot()):
        assert np.array_equal(x, y)
    assert pp._rng.integers(0, 2 ** 62) == jp._rng.integers(0, 2 ** 62)


# ---------------------------------------------------------------- engine
def _raw(memory=False):
    if memory:
        m = _memory_raw()
        return dict(m, sampling=RAW["sampling"],
                    train=[dict(m["train"][0], seed=5)])
    return RAW


@pytest.fixture(scope="module", params=["frozen", "memory"])
def lockstep(request):
    """Both engines after one train epoch under 'uniform' (6 steps), the
    JAX one at its default eval protocol ("auto")."""
    return _run_lockstep(_raw(request.param == "memory"),
                         jax_only=dict(fuse_steps=1))


def test_engine_losses_and_params_match_jax(lockstep):
    assert len(lockstep["pl"]) == 6
    np.testing.assert_allclose(lockstep["pl"], lockstep["jl"], rtol=TOL,
                               atol=TOL)
    _assert_params_match(lockstep)
    peng = lockstep["peng"]
    assert isinstance(peng.packer, StreamPacker)
    assert peng.packer._tcsr is not None and peng._sync_pack
    # packed on the main thread into the compact wire (JAX wire_dedup off)
    assert lockstep["wires"] == [("CompactWire", False)] * 6
    assert not lockstep["jeng"]._wire_dedup
    for a, b in zip(peng.packer.snapshot(), lockstep["jeng"].packer
                    .snapshot()):
        np.testing.assert_array_equal(a, b)


def test_engine_val_takes_column_chunks_and_matches_jax(lockstep, capsys):
    jeng, peng = lockstep["jeng"], lockstep["peng"]
    capsys.readouterr()
    jm = jeng.evaluate("val")
    pm = peng.evaluate("val")
    logged = [line for line in capsys.readouterr().out.splitlines()
              if "slot-unique protocol off" in line]
    assert logged == [f"[eval] slot-unique protocol off ({UNIFORM_GATE}); "
                      f"using the column-chunk protocol"] * 2
    assert peng.last_eval_trace["protocol"] == "column_chunk"
    assert 0.0 < pm <= 1.0
    assert abs(pm - jm) <= MRR_TOL, (pm, jm)
    for a, b in zip(peng.packer.snapshot(), jeng.packer.snapshot()):
        np.testing.assert_array_equal(a, b)
    assert (peng.packer._rng.bit_generator.state
            == jeng.packer._rng.bit_generator.state)
    if peng.use_memory:
        _assert_mem_state_match(peng, jeng, "after the val pass")


def test_warm_buckets_table_matches_jax_and_keeps_the_draws():
    raw = _raw(memory=True)
    peng = Engine(_data(synthetic), parse_config_dict(raw), device="cpu")
    jeng = JaxEngine(_data(jax_synthetic), jax_config(raw))
    state = peng.packer._rng.bit_generator.state
    peng.warm_buckets()
    jeng.warm_buckets()
    table = peng.packer.bucket_state()
    assert table == jeng.packer._sticky
    assert any(k[1] for k in table) and any(not k[1] for k in table)
    assert peng.packer._rng.bit_generator.state == state


def test_resume_equals_uninterrupted(tmp_path):
    """At dropout 0.1 with the memory: epoch 2 of a run resumed from the
    epoch-1 checkpoint equals the uninterrupted run's (loss, val MRR, the
    full state), since the checkpoint holds the draw stream; the draws
    moved on through the val pass."""
    raw = _raw(memory=True)
    raw = dict(raw, train=[dict(raw["train"][0], dropout=0.1,
                                att_dropout=0.1)])

    def engine():
        return Engine(_data(synthetic), parse_config_dict(raw), device="cpu")

    whole = engine()
    hw = whole.fit(epochs=2, log=lambda s: None, checkpoint_dir=str(tmp_path),
                   checkpoint_every=1)
    saved = torch.load(tmp_path / "ckpt_epoch0001.pt", weights_only=True)
    assert saved["packer"]["rng"].dtype == torch.int64
    resumed = engine()
    resumed.load_checkpoint(str(tmp_path / "ckpt_epoch0001.pt"))
    hr = resumed.fit(epochs=1, log=lambda s: None)
    assert hr["loss"] == hw["loss"][1:] and hr["val"] == hw["val"][1:]
    assert (resumed.packer._rng.bit_generator.state
            == whole.packer._rng.bit_generator.state)
    for a, b in zip(resumed.packer.snapshot(), whole.packer.snapshot()):
        np.testing.assert_array_equal(a, b)
    for f in whole.mem_state._fields:
        assert torch.equal(getattr(resumed.mem_state, f),
                           getattr(whole.mem_state, f)), f


def test_val_snapshot_does_not_rewind_the_draws():
    """As in JAX: ``restore_stream`` puts back the cache, clocks, cursor
    and memory, not the packer's draw stream."""
    eng = Engine(_data(synthetic), parse_config_dict(
        dict(RAW, train=[dict(RAW["train"][0], sanity_batches=2)])),
        device="cpu")
    eng.train_epoch()
    snap = eng.snapshot_stream()
    before = eng.packer._rng.bit_generator.state
    eng.evaluate("val")
    eng.restore_stream(snap)
    for a, b in zip(eng.packer.snapshot(), snap["packer"]):
        np.testing.assert_array_equal(a, b)
    assert eng.packer._rng.bit_generator.state != before


# ------------------------------------------------------------- refusals
def test_sharded_engine_refuses_uniform():
    from tgb_tgn_dgl_tpu_torch.parallel.engine import check_sharded
    with pytest.raises(ValueError, match="'recent' strategy only"):
        check_sharded(parse_config_dict(RAW), 1)
    check_sharded(parse_config_dict(
        dict(RAW, sampling=[dict(neighbor=[5])])), 1)


def test_multihost_engine_refuses_uniform():
    from tgb_tgn_dgl_tpu_torch.parallel.mh_engine import MultiHostEngine
    with pytest.raises(ValueError, match="'recent' strategy only"):
        MultiHostEngine(_data(synthetic), parse_config_dict(RAW), 2,
                        device="cpu")


@pytest.mark.parametrize("section,knob", [
    ("sampling", dict(strategy="latest")),
    ("train", dict(compute_dtype="float16"))], ids=["strategy", "dtype"])
def test_config_refuses_unknown_strategy_and_dtype(section, knob):
    raw = dict(RAW, **{section: [dict(RAW[section][0], **knob)]})
    with pytest.raises(ValueError, match=next(iter(knob))):
        parse_config_dict(raw).validate()
