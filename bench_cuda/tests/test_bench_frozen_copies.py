"""The benchmark's frozen copies equal the program's functions at this
commit: the traffic generator, the cost model, the attention byte count,
and the reference's stream rules that must match the port's layout (the
padded root count, the train negatives, the dependency blocks)."""
import importlib.util
import os

import numpy as np
import pytest

from conftest import ROOT


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 11])
def test_stream_equals_program_synthetic(seed):
    from bench_cuda.stream import synthetic
    from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic as prog
    a, b = synthetic("tgbl-wiki-small", seed=seed), prog("tgbl-wiki-small",
                                                         seed=seed)
    for f in ("src", "dst", "t", "msg", "train_mask", "val_mask",
              "test_mask", "val_ns", "test_ns"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    val_only = synthetic("tgbl-wiki-small", seed=seed, neg_splits=("val",))
    assert np.array_equal(val_only.val_ns, b.val_ns)
    assert val_only.test_ns is None
    assert synthetic("tgbl-wiki-small", seed=seed, neg_splits=()).val_ns \
        is None
    with pytest.raises(ValueError):
        synthetic("tgbl-wiki-small", seed=seed, neg_splits=("test",))


def test_flops_equal_program_cost_model():
    from bench_cuda import flops
    from tgb_tgn_dgl_tpu_torch.utils import flops as prog
    for name in ("H100_PEAK_BF16_FLOPS", "H100_PEAK_TF32_FLOPS",
                 "H100_PEAK_FP32_FLOPS", "H100_PEAK_HBM_BPS"):
        assert getattr(flops, name) == getattr(prog, name)
    for dt in ("float32", "bfloat16"):
        assert flops.peak_flops_for(dt) == prog.peak_flops_for(dt)
    for B, R, U, M, train in ((2000, 6144, 6144, 1, True),
                              (8000, 24576, 20480, 1, True),
                              (0, 46812, 0, 0, False),
                              (2000, 0, 7168, 999, False)):
        kw = dict(B=B, R=R, Kp=43, F=172, D=100, H=8, M=M, U=U, S=1,
                  updater="gru", n_params=494501, train=train, act_bytes=4)
        a, b = flops.flagship_step_cost(**kw), prog.flagship_step_cost(**kw)
        assert a == b
        assert flops.mfu_report(1.5e5, a, max(B, 1)) == prog.mfu_report(
            1.5e5, b, max(B, 1))


def test_attention_bytes_equal_chip_smoke():
    from bench_cuda import attn_bytes
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert attn_bytes.OPS_PER_ELEM == smoke.OPS_PER_ELEM
    for name in attn_bytes.ENTRY_POINTS:
        for R, Kp, H in ((6144, 43, 8), (24576, 43, 8), (46812, 43, 8)):
            bound_ms, _, nbytes = smoke.kernel_bound(name, R, Kp, H)
            assert attn_bytes.kernel_bytes(name, R, Kp, H) == nbytes
            assert attn_bytes.kernel_bound_s(name, R, Kp, H) * 1e3 == \
                pytest.approx(bound_ms, rel=1e-12)


def test_reference_stream_rules_equal_program():
    from bench_cuda.reference import stream_state as st
    from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
    from tgb_tgn_dgl_tpu_torch.engine.negatives import NegLinkSamplerDest
    rng = np.random.default_rng(5)
    src = rng.integers(0, 50, 3000)
    dst = rng.integers(50, 80, 3000)
    assert np.array_equal(st.level_batch(src, dst), get_block(src, dst))
    dsts = np.arange(50, 80)
    a, b = st.NegativeSampler(dsts, 7), NegLinkSamplerDest(dsts, seed=7)
    for _ in range(3):
        assert np.array_equal(a.sample(dst[:500]), b.sample(dst[:500]))
