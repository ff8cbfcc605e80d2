"""The port's segment reductions (tgb_tgn_dgl_tpu_torch/ops/segment.py,
plain torch) against the JAX package's (ops/segment.py, XLA segment ops),
as cases of one test, on seeded numpy inputs with empty segments, tied
keys and masked rows.  Sums, means and softmaxes agree within 1e-6 (fp32,
another summation order); max, argmax and last are exact."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import tgb_tgn_dgl_tpu.ops.segment as jseg
import tgb_tgn_dgl_tpu_torch.ops.segment as pseg

TOL = 1e-6
E, S = 40, 9          # rows, segments (segment 8 stays empty)


def _inputs(width):
    rng = np.random.default_rng(width)
    ids = rng.integers(0, S - 1, E).astype(np.int32)
    data = rng.normal(size=(E, width) if width else E).astype(np.float32)
    # ties: a few keys repeat their segment's largest value
    key = rng.integers(0, 4, E).astype(np.float32)
    mask = rng.random(E) > 0.25
    return ids, data, key, mask


def _call(mod, name, width, masked, tie):
    ids, data, key, mask = _inputs(width)
    conv = ((lambda a: jnp.asarray(a)) if mod is jseg
            else (lambda a: torch.from_numpy(np.asarray(a))))
    ids, data, key = conv(ids), conv(data), conv(key)
    m = conv(mask) if masked else None
    fn = getattr(mod, name)
    if name in ("segment_sum", "segment_max"):
        return fn(data, ids, S)
    if name in ("segment_mean", "segment_softmax"):
        return fn(data, ids, S, mask=m)
    if name == "segment_argmax":
        return fn(key, ids, S, mask=m, tie=tie)
    return fn(data, ids, key, S, mask=m)            # segment_last


CASES = [("segment_sum", 0, False, None), ("segment_sum", 3, False, None),
         ("segment_max", 0, False, None), ("segment_max", 3, False, None),
         ("segment_mean", 3, False, None), ("segment_mean", 3, True, None),
         ("segment_mean", 0, True, None),
         ("segment_argmax", 0, False, "last"),
         ("segment_argmax", 0, True, "last"),
         ("segment_argmax", 0, True, "first"),
         ("segment_last", 4, False, None), ("segment_last", 4, True, None),
         ("segment_softmax", 0, True, None),
         ("segment_softmax", 2, False, None),
         ("segment_softmax", 2, True, None)]


@pytest.mark.parametrize("name,width,masked,tie", CASES,
                         ids=[f"{n[8:]}-w{w}{'-mask' if m else ''}"
                              f"{'-' + t if t else ''}"
                              for n, w, m, t in CASES])
def test_segment_reduction_matches_jax(name, width, masked, tie):
    got = _call(pseg, name, width, masked, tie)
    want = _call(jseg, name, width, masked, tie)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        elif name in ("segment_max", "segment_argmax", "segment_last"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    if name == "segment_argmax":
        # the empty segment: value -inf, an index out of range
        assert got[0][S - 1] == float("-inf")
        assert got[1][S - 1] == (E if tie == "last" else 2 ** 31 - 1)
