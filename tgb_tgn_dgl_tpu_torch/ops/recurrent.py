"""GRU / vanilla-RNN cells for node-memory updates — the port's
counterpart of tgb_tgn_dgl_tpu/ops/recurrent.py.

torch.nn.GRUCell math (gate order r, z, n), but with the JAX package's
parameter layout: ``w_ih`` (in, 3H) and ``w_hh`` (H, 3H) multiply from
the right, so ``bridge.py`` carries the weights as they are, under the
names ``cell.w_ih``, ``cell.w_hh``, ``cell.b_ih``, ``cell.b_hh``.  Every
leaf starts from torch's default U(±1/sqrt(H)).  Plain torch matmuls, as
they are plain XLA dots in the JAX package; no kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def _uniform(shape, bound: float, generator) -> nn.Parameter:
    return nn.Parameter(
        (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound)


class GRUCell(nn.Module):
    """``gru_cell``: x (..., in), h (..., H) -> h' (..., H).

    r = σ(x W_ir + b_ir + h W_hr + b_hr)
    z = σ(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r ⊙ (h W_hn + b_hn))
    h' = (1 − z) n + z h
    """

    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden_dim)
        g = 3 * hidden_dim
        self.w_ih = _uniform((input_dim, g), bound, generator)
        self.w_hh = _uniform((hidden_dim, g), bound, generator)
        self.b_ih = _uniform((g,), bound, generator)
        self.b_hh = _uniform((g,), bound, generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        gi = x @ self.w_ih + self.b_ih
        gh = h @ self.w_hh + self.b_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class RNNCell(nn.Module):
    """``rnn_cell``, torch.nn.RNNCell (tanh): h' = tanh(x W_ih + b_ih +
    h W_hh + b_hh)."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden_dim)
        self.w_ih = _uniform((input_dim, hidden_dim), bound, generator)
        self.w_hh = _uniform((hidden_dim, hidden_dim), bound, generator)
        self.b_ih = _uniform((hidden_dim,), bound, generator)
        self.b_hh = _uniform((hidden_dim,), bound, generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x @ self.w_ih + self.b_ih + h @ self.w_hh
                          + self.b_hh)


CELLS = {"gru": GRUCell, "rnn": RNNCell}
