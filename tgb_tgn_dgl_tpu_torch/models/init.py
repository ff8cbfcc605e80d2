"""Parameter initializers and dropout — the port's counterpart of
tgb_tgn_dgl_tpu/models/init.py.

MRR parity depends on the init *distributions* (not bitwise values):
xavier_normal_ with relu gain for the attention projections (reference
model_utils.py:550-558), torch.nn.Linear defaults (U(±1/sqrt(fan_in))
weight and bias) elsewhere.  Parameters are drawn from an explicit
``torch.Generator``.

Random streams.  The JAX package derives one dropout key per consumer
(``derive_key``); torch has no such derivation, so the port draws every
random number from one ``torch.Generator`` in a fixed order instead:

  * init: ``Engine`` seeds a CPU generator with ``train.seed`` and draws
    the model's leaves (``models/factory.init_arch``): for TGN and DyRep
    in the order of ``models/tgnn.init_tgnn`` (``gat``, ``pred``, then
    ``gat2`` … ``gat{L}``), for JODIE ``jodie.weight`` (the time
    projection; its bias is zero), then ``pred``'s ``src_fc``, ``dst_fc``
    and ``out_fc``; then, with the memory, the cell's ``w_ih``, ``w_hh``,
    ``b_ih``, ``b_hh`` (``models/memory.init_memory``, and for DyRep's
    eager memory ``models/variants.init_eager_memory``, whose cell takes
    the stored mail of width 2D + F + D);
  * dropout: ``Engine`` seeds a generator on its device with
    ``train.seed + 1``; each train step draws, layer by layer and in this
    order within a layer, the masks of the source features, the root
    features, the edge features, the time encoding and the attention
    probabilities (``tgnn_embed``).

The two frameworks give different numbers from the same seed, so parity
tests run at dropout 0 or hand both sides the same mask.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

RELU_GAIN = math.sqrt(2.0)


def xavier_normal(shape: Sequence[int], gain: float = RELU_GAIN,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """torch.nn.init.xavier_normal_ semantics: for 2D (out, in) tensors
    fan_in=in, fan_out=out; for >2D (a, b, *rest) fan_in=b*prod(rest),
    fan_out=a*prod(rest)."""
    if len(shape) == 2:
        fan_out, fan_in = shape
    else:
        receptive = math.prod(shape[2:])
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(tuple(shape), generator=generator)


def _uniform(shape, bound: float, generator) -> torch.Tensor:
    return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) * bound


def linear_default(in_dim: int, out_dim: int,
                   generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear with torch's default init drawn from ``generator``:
    weight (out, in) and bias both U(±1/sqrt(in))."""
    lin = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        lin.weight.copy_(_uniform((out_dim, in_dim), bound, generator))
        lin.bias.copy_(_uniform((out_dim,), bound, generator))
    return lin


def linear_xavier(in_dim: int, out_dim: int, gain: float = RELU_GAIN,
                  generator: Optional[torch.Generator] = None) -> nn.Linear:
    """xavier_normal_ weight + torch-default bias, as the reference's
    reset_parameters does for fc_node/fc_edge (model_utils.py:552-553:
    only the weight is re-initialized; the bias keeps Linear defaults)."""
    lin = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    with torch.no_grad():
        lin.weight.copy_(xavier_normal((out_dim, in_dim), gain, generator))
        lin.bias.copy_(_uniform((out_dim,), 1.0 / math.sqrt(in_dim),
                                generator))
    return lin


def _kept(shape, keep: float, generator, device) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=device) < keep


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Pre-scaled dropout multiplier: 1/keep where kept, else 0."""
    keep = 1.0 - rate
    return _kept(shape, keep, generator, device).to(torch.float32) / keep


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(_kept(x.shape, keep, generator, x.device), x / keep,
                       0.0)
