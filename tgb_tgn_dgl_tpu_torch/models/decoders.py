"""Decoder heads — the port's counterpart of
tgb_tgn_dgl_tpu/models/decoders.py (reference modules/decoder.py).

  * ``LinkPredictor`` (reference :12-27): 2-tower MLP, h = relu(lin_src(z_src)
    + lin_dst(z_dst)), score = lin_final(h).
  * ``NodePredictor`` (reference :30-41): lin2(relu(lin1(z))).
  * ``ConvTransE`` (reference :45-123): the temporal-knowledge-graph
    decoder of RE-GCN/CEN-style models.  (subject, relation) embeddings
    stacked as a 2-channel 1-D image, a Conv1d over the embedding axis,
    a projection back to the embedding width, and an inner product with
    every entity embedding.

Plain dense torch, as the JAX package computes them outside Pallas; no
kernel.  Parameters are drawn from an explicit ``torch.Generator``, each
dropout mask from the generator handed to the call.

ConvTransE's batch norms keep their running statistics as buffers
(``bnX.mean``, ``bnX.var``) that this module updates itself, exactly as
the JAX package carries its ``BNState``: normalise a train batch with its
biased variance, and move the running variance toward that same biased
value (``nn.BatchNorm1d`` would move it toward the unbiased one).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .init import dropout, linear_default


class LinkPredictor(nn.Module):
    def __init__(self, in_dim: int, hidden: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = hidden or in_dim
        self.lin_src = linear_default(in_dim, hidden, generator)
        self.lin_dst = linear_default(in_dim, hidden, generator)
        self.lin_final = linear_default(hidden, 1, generator)

    def forward(self, z_src: torch.Tensor,
                z_dst: torch.Tensor) -> torch.Tensor:
        """Logits of shape z_src.shape[:-1]; z_dst may carry one more
        leading dim ((B, M, D) candidates against (B, D) sources)."""
        s = self.lin_src(z_src)
        d = self.lin_dst(z_dst)
        if d.dim() == s.dim() + 1:
            s = s[..., None, :]
        return self.lin_final(torch.relu(s + d))[..., 0]


class NodePredictor(nn.Module):
    def __init__(self, in_dim: int, num_classes: int,
                 hidden: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = hidden or in_dim
        self.lin1 = linear_default(in_dim, hidden, generator)
        self.lin2 = linear_default(hidden, num_classes, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.lin2(torch.relu(self.lin1(z)))


class BatchNorm(nn.Module):
    """A batch norm over ``axes`` whose channel is the last axis not
    reduced: parameters ``scale``, ``bias``; buffers ``mean`` (zeros) and
    ``var`` (ones), updated in train mode with the batch's biased
    statistics (momentum 0.1, eps 1e-5)."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        self.momentum = momentum
        self.eps = eps

    def forward(self, x: torch.Tensor, axes: Sequence[int],
                train: bool) -> torch.Tensor:
        if train:
            mean = x.mean(dim=tuple(axes))
            var = x.var(dim=tuple(axes), correction=0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(1 - m).add_(m * mean)
                self.var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.mean, self.var
        shape = [1] * x.dim()
        shape[[a for a in range(x.dim()) if a not in axes][-1]] = -1
        xn = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                    + self.eps)
        return xn * self.scale.reshape(shape) + self.bias.reshape(shape)


class ConvTransE(nn.Module):
    """Parameters ``conv_w`` (C, 2, ks) U(±1/sqrt(2·ks)), ``conv_b`` (C,)
    zeros, ``bn0`` (2), ``bn1`` (C), ``bn2`` (D) and ``fc`` (C·D -> D),
    drawn in the order conv_w, fc."""

    def __init__(self, embed_dim: int, channels: int = 50,
                 kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(2 * kernel_size)
        self.conv_w = nn.Parameter(
            (torch.rand((channels, 2, kernel_size), generator=generator)
             * 2.0 - 1.0) * bound)
        self.conv_b = nn.Parameter(torch.zeros(channels))
        self.bn0 = BatchNorm(2)
        self.bn1 = BatchNorm(channels)
        self.bn2 = BatchNorm(embed_dim)
        self.fc = linear_default(channels * embed_dim, embed_dim, generator)

    def forward(self, ent_table: torch.Tensor, sub_emb: torch.Tensor,
                rel_emb: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None,
                input_drop: float = 0.2, hidden_drop: float = 0.2,
                feature_drop: float = 0.2) -> torch.Tensor:
        """Scores (B, N): every entity of ``ent_table`` (N, D) as the
        object of each (subject (B, D), relation (B, D)) query.  In train
        mode the batch norms update their running statistics, and the
        input, feature and hidden dropout masks are drawn from
        ``generator`` in that order."""
        det = not train
        x = torch.stack([sub_emb, rel_emb], dim=1)           # (B, 2, D)
        x = self.bn0(x, (0, 2), train)
        x = dropout(x, input_drop, generator, det)
        # SAME padding over the embedding axis (torch: padding=ks//2)
        ks = self.conv_w.shape[-1]
        x = F.conv1d(x, self.conv_w, padding=ks // 2) \
            + self.conv_b[None, :, None]                      # (B, C, D)
        x = self.bn1(x, (0, 2), train)
        x = torch.relu(x)
        x = dropout(x, feature_drop, generator, det)
        x = self.fc(x.reshape(x.shape[0], -1))               # (B, D)
        x = dropout(x, hidden_drop, generator, det)
        x = torch.relu(self.bn2(x, (0,), train))
        return x @ ent_table.T
