"""Frozen cost of one DyGFormer train step (models/dygformer.py), kept under
the benchmark so that a later change to the program cannot move the
yardstick that ``dygformer_train_mfu_pct`` is read against.

It counts the matmul FLOPs of the step as the model runs it (a fused
multiply-add counts 2): the node, edge and time projections once per end
of an event (src, dst and each negative: each end's tokens are the same
in every pair it takes part in), the co-occurrence encoding and its
projection per pair, the Transformer layers per pair (the in-projection,
the two attention products, the out-projection, the 4x feed-forward),
the output layer and the scorer; the backward at 2x the forward, as
``flops.py`` counts it, and Adam at 10 FLOPs a parameter.  Elementwise
work (LayerNorm, softmax, GELU, dropout, the cosines) is left out: it is
under a twentieth of the count at the published widths.
"""
from __future__ import annotations

from typing import Dict


def dygformer_step_cost(*, B: int, M: int, L: int, patch: int, C: int,
                        layers: int, node_dim: int, edge_dim: int,
                        time_dim: int, n_params: int,
                        train: bool = True) -> Dict[str, float]:
    """FLOPs of one step over B (padded) events with M negatives each:
    ``flops`` (forward, and with ``train`` the backward and Adam),
    ``flops_fwd`` and ``flops_encoder`` (the layers' forward)."""
    P = B * (1 + M)                  # pair passes
    T = L // patch                   # tokens of an end
    D = 4 * C                        # token width
    end_tokens = B * (2 + M) * T
    pair_tokens = P * 2 * T
    f_chan = 2.0 * end_tokens * patch * (node_dim + edge_dim + time_dim) * C
    counts = P * 2 * L * 2           # a count per position and channel
    f_cooc = (2.0 * counts * C + 2.0 * counts * C * C
              + 2.0 * pair_tokens * patch * C * C)
    per_layer = (2.0 * pair_tokens * D * 3 * D        # q, k, v
                 + 2.0 * 2.0 * P * (2 * T) ** 2 * D   # scores and weights
                 + 2.0 * pair_tokens * D * D          # out-projection
                 + 2.0 * 2.0 * pair_tokens * D * 4 * D)  # feed-forward
    f_enc = layers * per_layer
    f_out = 2.0 * 2 * P * D * node_dim + 2.0 * P * (2 * node_dim * node_dim
                                                    + node_dim)
    fwd = f_chan + f_cooc + f_enc + f_out
    flops = fwd + (2.0 * fwd + 10.0 * n_params if train else 0.0)
    return {"flops": float(flops), "flops_fwd": float(fwd),
            "flops_encoder": float(f_enc)}
