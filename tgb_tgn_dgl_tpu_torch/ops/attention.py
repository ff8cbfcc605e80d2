"""Fused masked row attention (scalar-message mode) — the port's
counterpart of tgb_tgn_dgl_tpu/ops/pallas_attention.py.

The hot inner op of the flagship embedding (models/tgnn.py scalar mode,
reference EdgeGATConv + edge_softmax, model_utils.py:560-599): for every
root slot r and head h over its Kp in-edge columns

    logit[r,k,h] = leaky_relu(el'[r,k,h] + er[r,h])
    a            = masked softmax over k        (optionally · drop mask)
    out[r,h]     = Σ_k a[r,k,h] · el'[r,k,h]

Layout as in the JAX package: el' (R, Kp, H), er (R, H), mask (R, Kp)
bool, drop mask (R, Kp, H) pre-scaled to 1/keep or 0; out (R, H).

``attention_core`` dispatches on the device of its input: a CPU tensor
goes to ``attention_core_reference`` (the plain torch version), a CUDA
tensor to the hand-written kernels of csrc/attention.cu.  When no
gradient is needed (``infer_route``) that is the forward without the
residual ``a``, ``attention_fwd_infer``; otherwise it goes through two
``torch.autograd.Function``s (without and with the drop mask) whose
backward is a kernel too.  There is no fallback from CUDA to the plain
version: a kernel that fails to build or launch raises.

``launch_counts`` counts the launches of each kernel entry point, so a
run can show that its main path went through them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .segment import masked_softmax

KERNELS = ("attention_fwd", "attention_fwd_infer", "attention_bwd",
           "attention_fwd_drop", "attention_bwd_drop")
launch_counts = {name: 0 for name in KERNELS}
# the kernels hold a row's head vectors in one warp's lanes
MAX_HEADS = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # el, er, mask, [dm], out, a, R, Kp, H, slope, stream
    "attention_fwd": [_P] * 5 + [_I] * 3 + [_F, _P],
    "attention_fwd_drop": [_P] * 6 + [_I] * 3 + [_F, _P],
    # el, er, mask, out, R, Kp, H, slope, stream
    "attention_fwd_infer": [_P] * 4 + [_I] * 3 + [_F, _P],
    # el, er, mask, [dm], a, g, d_el, d_er, R, Kp, H, slope, stream
    "attention_bwd": [_P] * 7 + [_I] * 3 + [_F, _P],
    "attention_bwd_drop": [_P] * 8 + [_I] * 3 + [_F, _P],
}
_fns: dict = {}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


# ----------------------------------------------------------------- plain
def attention_probs_reference(el_prime: torch.Tensor, er: torch.Tensor,
                              mask: torch.Tensor, negative_slope: float
                              ) -> torch.Tensor:
    """Plain torch softmax probabilities (R, Kp, H), 0 where masked: the
    forward kernels' residual ``a``."""
    x = el_prime + er[:, None, :]
    logits = torch.where(x >= 0, x, x * negative_slope)
    return masked_softmax(logits, mask[..., None], dim=1)


def attention_core_reference(el_prime: torch.Tensor, er: torch.Tensor,
                             mask: torch.Tensor, negative_slope: float,
                             drop_mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain torch version: el' (R, Kp, H), er (R, H), mask (R, Kp) ->
    (R, H).  The XLA chain of tgb_tgn_dgl_tpu/models/tgnn.py:232-236 with
    the drop mask applied between the softmax and the weighted sum."""
    a = attention_probs_reference(el_prime, er, mask, negative_slope)
    if drop_mask is not None:
        a = a * drop_mask
    return torch.sum(a * el_prime, dim=1)


def attention_bwd_reference(el_prime: torch.Tensor, er: torch.Tensor,
                            mask: torch.Tensor, a: torch.Tensor,
                            g: torch.Tensor, negative_slope: float,
                            drop_mask: Optional[torch.Tensor] = None):
    """Plain torch version of the backward kernels, from the residual ``a``
    (the softmax before dropout) and the output gradient ``g`` (R, H) ->
    (d_el' (R, Kp, H), d_er (R, H)): ``_bwd_kernel`` / ``_bwd_kernel_drop``
    of tgb_tgn_dgl_tpu/ops/pallas_attention.py:68-85, :112-129."""
    gd = g[:, None, :] if drop_mask is None else g[:, None, :] * drop_mask
    da = gd * el_prime
    s = torch.sum(a * da, dim=1, keepdim=True)
    dl = a * (da - s)
    x = el_prime + er[:, None, :]
    dx = torch.where(x >= 0, dl, dl * negative_slope)
    dx = torch.where(mask[..., None], dx, torch.zeros_like(dx))
    return dx + a * gd, torch.sum(dx, dim=1)


# ---------------------------------------------------------------- kernels
def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("attention"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if (t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            f"attention kernel: {name} must be a contiguous {dtype} tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _launch(name: str, ptrs, R: int, Kp: int, H: int, slope: float) -> None:
    """Launch entry point ``name`` on the current stream and count it.  An
    empty batch (R = 0) launches nothing: a grid of no blocks is an
    error."""
    if R == 0:
        return
    stream = torch.cuda.current_stream().cuda_stream
    rc = _fn(name)(*ptrs, R, Kp, H, float(slope), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    launch_counts[name] += 1


def _check_inputs(el, er, mask, dm):
    if el.dim() != 3:
        raise ValueError(f"attention kernel: el' must be (R, Kp, H), got "
                         f"shape {tuple(el.shape)}")
    R, Kp, H = el.shape
    if H > MAX_HEADS:
        raise ValueError(f"attention kernel: at most {MAX_HEADS} heads, "
                         f"got H={H}")
    dev = el.device
    if dev.type != "cuda":
        raise ValueError(f"attention kernel needs CUDA tensors, got {dev}")
    _check("el'", el, (R, Kp, H), torch.float32, dev)
    _check("er", er, (R, H), torch.float32, dev)
    _check("mask", mask, (R, Kp), torch.bool, dev)
    if dm is not None:
        _check("drop_mask", dm, (R, Kp, H), torch.float32, dev)
    return R, Kp, H


def attention_fwd(el: torch.Tensor, er: torch.Tensor, mask: torch.Tensor,
                  negative_slope: float,
                  drop_mask: Optional[torch.Tensor] = None):
    """Forward kernel -> (out (R, H), a (R, Kp, H)); ``a`` holds the
    probabilities before dropout (the backward's residual)."""
    R, Kp, H = _check_inputs(el, er, mask, drop_mask)
    out = torch.empty((R, H), dtype=torch.float32, device=el.device)
    a = torch.empty_like(el)
    ptrs = [el.data_ptr(), er.data_ptr(), mask.data_ptr()]
    name = "attention_fwd"
    if drop_mask is not None:
        ptrs.append(drop_mask.data_ptr())
        name = "attention_fwd_drop"
    with torch.cuda.device(el.device):
        _launch(name, ptrs + [out.data_ptr(), a.data_ptr()], R, Kp, H,
                negative_slope)
    return out, a


def attention_fwd_infer(el: torch.Tensor, er: torch.Tensor,
                        mask: torch.Tensor, negative_slope: float
                        ) -> torch.Tensor:
    """Forward kernel without the residual -> out (R, H), for calls that
    need no gradient."""
    R, Kp, H = _check_inputs(el, er, mask, None)
    out = torch.empty((R, H), dtype=torch.float32, device=el.device)
    with torch.cuda.device(el.device):
        _launch("attention_fwd_infer", [el.data_ptr(), er.data_ptr(),
                                        mask.data_ptr(), out.data_ptr()],
                R, Kp, H, negative_slope)
    return out


def attention_bwd(el: torch.Tensor, er: torch.Tensor, mask: torch.Tensor,
                  a: torch.Tensor, g: torch.Tensor, negative_slope: float,
                  drop_mask: Optional[torch.Tensor] = None):
    """Backward kernel -> (d_el (R, Kp, H), d_er (R, H)); no gradient
    flows to the mask or the drop mask."""
    R, Kp, H = _check_inputs(el, er, mask, drop_mask)
    _check("a", a, (R, Kp, H), torch.float32, el.device)
    _check("grad", g, (R, H), torch.float32, el.device)
    d_el = torch.empty_like(el)
    d_er = torch.empty((R, H), dtype=torch.float32, device=el.device)
    ptrs = [el.data_ptr(), er.data_ptr(), mask.data_ptr()]
    name = "attention_bwd"
    if drop_mask is not None:
        ptrs.append(drop_mask.data_ptr())
        name = "attention_bwd_drop"
    with torch.cuda.device(el.device):
        _launch(name, ptrs + [a.data_ptr(), g.data_ptr(), d_el.data_ptr(),
                              d_er.data_ptr()], R, Kp, H, negative_slope)
    return d_el, d_er


class _AttentionCore(torch.autograd.Function):
    """Counterpart of the custom VJP ``_attention_pallas``
    (pallas_attention.py:257-300)."""

    @staticmethod
    def forward(ctx, el_prime, er, mask, negative_slope):
        out, a = attention_fwd(el_prime, er, mask, negative_slope)
        ctx.save_for_backward(el_prime, er, mask, a)
        ctx.negative_slope = negative_slope
        return out

    @staticmethod
    def backward(ctx, g):
        el_prime, er, mask, a = ctx.saved_tensors
        d_el, d_er = attention_bwd(el_prime, er, mask, a, g.contiguous(),
                                   ctx.negative_slope)
        return d_el, d_er, None, None


class _AttentionCoreDrop(torch.autograd.Function):
    """Counterpart of the custom VJP ``_attention_pallas_drop``
    (pallas_attention.py:303-345)."""

    @staticmethod
    def forward(ctx, el_prime, er, mask, drop_mask, negative_slope):
        out, a = attention_fwd(el_prime, er, mask, negative_slope,
                               drop_mask)
        ctx.save_for_backward(el_prime, er, mask, drop_mask, a)
        ctx.negative_slope = negative_slope
        return out

    @staticmethod
    def backward(ctx, g):
        el_prime, er, mask, drop_mask, a = ctx.saved_tensors
        d_el, d_er = attention_bwd(el_prime, er, mask, a, g.contiguous(),
                                   ctx.negative_slope, drop_mask)
        return d_el, d_er, None, None, None


def infer_route(el_prime: torch.Tensor, er: torch.Tensor,
                drop_mask: Optional[torch.Tensor]) -> bool:
    """Whether ``attention_core`` takes the forward without the residual:
    no drop mask (dropout is off at eval), and no gradient to compute,
    because autograd is off or neither el' nor er requires one."""
    return drop_mask is None and not (
        torch.is_grad_enabled()
        and (el_prime.requires_grad or er.requires_grad))


def attention_core(el_prime: torch.Tensor, er: torch.Tensor,
                   mask: torch.Tensor, negative_slope: float,
                   drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked row attention (R, Kp, H) -> (R, H) in fp32: the plain version
    for a CPU tensor, the CUDA kernels for a CUDA tensor.  el′ and er are
    cast to fp32 first on both devices (a bfloat16 caller's gradients come
    back in bfloat16 through the cast), as the JAX Pallas route does
    (tgb_tgn_dgl_tpu/ops/pallas_attention.py:362-366)."""
    el_prime = el_prime.to(torch.float32)
    er = er.to(torch.float32)
    if el_prime.device.type == "cpu":
        return attention_core_reference(el_prime, er, mask, negative_slope,
                                        drop_mask)
    el_prime = el_prime.contiguous()
    er = er.contiguous()
    mask = mask.contiguous()
    if infer_route(el_prime, er, drop_mask):
        return attention_fwd_infer(el_prime, er, mask, float(negative_slope))
    if drop_mask is None:
        return _AttentionCore.apply(el_prime, er, mask,
                                    float(negative_slope))
    return _AttentionCoreDrop.apply(el_prime, er, mask,
                                    drop_mask.to(torch.float32).contiguous(),
                                    float(negative_slope))
