"""The attention kernels' byte and operation counts: a frozen copy of the
arithmetic of ``chip_smoke.py::kernel_bound`` (and its ``OPS_PER_ELEM``),
for the five entry points of ``tgb_tgn_dgl_tpu_torch/csrc/attention.cu``
at a launch shape (R root slots, Kp in-edge columns, H heads).

Each input byte is counted once for its read and each output byte once
for its write: el' (R, Kp, H) f32, er (R, H) f32, the (R, Kp) u8 mask, the
drop mask (R, Kp, H) f32 where there is one; the forward writes out (R, H)
and, when a backward follows, the softmax residual a (R, Kp, H); the
backward reads a and the output gradient (R, H) and writes d_el' and d_er.
``bench_cuda/tests`` hold these counts equal to the program's.
"""
from __future__ import annotations

from .flops import H100_PEAK_FP32_FLOPS, H100_PEAK_HBM_BPS

ENTRY_POINTS = ("attention_fwd", "attention_fwd_infer", "attention_bwd",
                "attention_fwd_drop", "attention_bwd_drop")
OPS_PER_ELEM = {"attention_fwd": 10, "attention_fwd_infer": 10,
                "attention_fwd_drop": 11, "attention_bwd": 12,
                "attention_bwd_drop": 14}


def kernel_bytes(name: str, R: int, Kp: int, H: int) -> int:
    """HBM bytes one launch of entry point ``name`` has to move."""
    if name not in OPS_PER_ELEM:
        raise ValueError(f"unknown attention entry point {name!r}")
    rkh, rh = R * Kp * H, R * H
    if name == "attention_fwd_infer":
        # el', er, mask in; out out
        nbytes = 4 * rkh + 4 * rh + R * Kp + 4 * rh
    elif name.startswith("attention_fwd"):
        # el', er, mask, [dm] in; out, a out
        nbytes = 4 * rkh + 4 * rh + R * Kp + 4 * rh + 4 * rkh
    else:
        # el', er, mask, [dm], a, grad in; d_el', d_er out
        nbytes = (4 * rkh + 4 * rh + R * Kp + 4 * rkh + 4 * rh
                  + 4 * rkh + 4 * rh)
    nbytes += 4 * rkh if name.endswith("_drop") else 0
    return nbytes


def kernel_bound_s(name: str, R: int, Kp: int, H: int) -> float:
    """The least seconds one launch can take on the card: the larger of
    its bytes over the HBM rate and its operations over the fp32 peak."""
    ops = OPS_PER_ELEM[name] * R * Kp * H
    return max(kernel_bytes(name, R, Kp, H) / H100_PEAK_HBM_BPS,
               ops / H100_PEAK_FP32_FLOPS)
