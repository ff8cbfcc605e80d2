"""Frozen copy of the port's cost model,
``tgb_tgn_dgl_tpu_torch/utils/flops.py``, kept under the benchmark so
that a later change to the program cannot move the yardstick that the
benchmark's ``*_mfu_pct`` metrics are read against.  The arithmetic
below is the program's, term for term (``bench_cuda/tests`` hold the two
equal); only this paragraph was added.

Analytic cost model: FLOPs and HBM bytes of one packed TGN step.

The port's copy of tgb_tgn_dgl_tpu/utils/flops.py.  It counts the dense
work of one packed batch through the TGNN step (models/tgnn.py, scalar
message mode with concat-free edge projections), so that a caller who has
measured a rate can say what share of the card's roofline the step uses:
achieved TFLOP/s, the share of peak FLOP/s (MFU) and of peak HBM bytes/s.

Conventions: a fused multiply-add counts as 2 FLOPs; the backward pass of
a matmul chain costs 2x its forward; elementwise work is counted where it
is within ~10x of the matmul term (time encode, softmax) and dropped
otherwise.  Byte counts assume the compute dtype for activations and f32
for parameters and optimizer state, counting each major intermediate once
for its write and once for its read.  They are the traffic the algorithm
needs, not what the port moves: the eager step writes and reads every
intermediate of every op (and the casts and copies between them) through
HBM, so it exceeds this count, and the share of peak bytes/s read from it
is a LOWER bound on the HBM rate the step really drives.

The module is host arithmetic on shapes: it reads nothing from a device
and runs the same on the CPU and on the GPU.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates (no sparsity),
at its 700 W power limit.  Float32 runs outside the tensor cores while
TF32 is off, as it is in torch by default and in every module of the port.
"""
from __future__ import annotations

from typing import Dict, Mapping

H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_TF32_FLOPS = 495e12
H100_PEAK_FP32_FLOPS = 67e12
H100_PEAK_HBM_BPS = 3.35e12


def peak_flops_for(compute_dtype: str) -> float:
    """The H100's peak FLOP/s for ``train.compute_dtype`` (TF32 off)."""
    return {"float32": H100_PEAK_FP32_FLOPS,
            "bfloat16": H100_PEAK_BF16_FLOPS}[compute_dtype]


def count_params(params) -> int:
    """Elements of every tensor of a model's state: an ``nn.Module`` (its
    parameters and its buffers, as its ``state_dict`` holds them), a
    mapping of tensors (a ``state_dict``, ``bridge.params_from_jax``'s
    output) or an iterable of tensors.  For an Engine's model it equals
    the JAX ``count_params(engine.params)``: the port holds the memory's
    parameters as ``model.memory``, JAX as ``params["memory"]``."""
    if hasattr(params, "state_dict"):
        params = params.state_dict()
    if isinstance(params, Mapping):
        params = params.values()
    return int(sum(t.numel() for t in params))


def flagship_step_cost(
    *,
    B: int,                 # events per batch
    R: int,                 # padded root slots
    Kp: int,                # in-edges per root slot (K + 1 + P)
    F: int,                 # edge feature dim
    D: int,                 # hidden dim
    H: int,                 # attention heads
    M: int = 1,             # negatives per event
    U: int = 0,             # unique-node rows (memory mode), 0 = frozen
    S: int = 1,             # mailbox slots
    updater: str = "gru",   # memory cell ('gru' = 3 gates, 'rnn' = 1)
    n_params: int = 0,
    train: bool = True,
    act_bytes: int = 2,     # bf16 activations
) -> Dict[str, float]:
    """FLOPs + HBM bytes for ONE step (forward [+backward+Adam])."""
    E = R * Kp              # in-edge grid cells
    # --- forward: embedding ------------------------------------------
    f_te = 3.0 * E * D                       # cos(w*dt+b)
    f_el = 2.0 * E * D * H                   # src projection -> heads
    f_ee = 2.0 * E * (F + D) * H             # split edge projection
    f_er = 2.0 * R * D * H                   # root projection
    f_attn = 10.0 * E * H                    # leaky+softmax+weighted sum
    fwd_embed = f_te + f_el + f_ee + f_er + f_attn
    # --- forward: predictor ------------------------------------------
    towers = B * (2 + M)                     # src/pos towers + M negs
    fwd_pred = 2.0 * towers * D * D + 2.0 * towers * D
    # --- forward: mailbox memory (0 when frozen) ---------------------
    fwd_mem = 0.0
    if U:
        msg_dim = 2 * D + F + D
        gates = 3 if updater == "gru" else 1
        fwd_mem = (2.0 * U * gates * (msg_dim + D) * D    # cell matmuls
                   + 3.0 * U * S * D)                     # Δt encode
    fwd = fwd_embed + fwd_pred + fwd_mem
    # --- backward + optimizer ----------------------------------------
    bwd = 2.0 * fwd if train else 0.0
    adam = 10.0 * n_params if train else 0.0
    flops = fwd + bwd + adam

    # --- HBM bytes (major intermediates, fwd+bwd) --------------------
    grid_bytes = E * (F + 2 * D + 3 * H) * act_bytes      # ef, te, mem, el/ee/a
    mem_bytes = (U * (S * (2 * D + F + D) + 2 * D) * act_bytes) if U else 0
    passes = 3.0 if train else 1.0           # fwd + bwd reads/writes
    param_bytes = (3 * 4 * n_params * 2) if train else 4 * n_params
    bytes_ = passes * (grid_bytes + mem_bytes) + param_bytes
    return {
        "flops": float(flops),
        "bytes": float(bytes_),
        "flops_fwd": float(fwd),
        "arithmetic_intensity": float(flops / max(bytes_, 1.0)),
    }


def mfu_report(events_per_sec: float, cost: Dict[str, float],
               events_per_step: int,
               peak_flops: float = H100_PEAK_FP32_FLOPS,
               peak_bps: float = H100_PEAK_HBM_BPS) -> Dict[str, float]:
    """Achieved TFLOP/s, MFU and HBM utilization at a measured rate; by
    default against the fp32 peak, the port's default compute dtype."""
    steps_per_sec = events_per_sec / max(events_per_step, 1)
    achieved_flops = steps_per_sec * cost["flops"]
    achieved_bps = steps_per_sec * cost["bytes"]
    return {
        "flops_per_event": cost["flops"] / max(events_per_step, 1),
        "tflops": achieved_flops / 1e12,
        "mfu": achieved_flops / peak_flops,
        "hbm_gbps": achieved_bps / 1e9,
        "hbm_util": achieved_bps / peak_bps,
    }
