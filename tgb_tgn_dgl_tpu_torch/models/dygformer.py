"""DyGFormer (Yu, Sun, Du and Lv, "Towards Better Dynamic Graph Learning:
New Architecture and Unified Library", NeurIPS 2023, arXiv:2303.13047;
DyGLib ``models/DyGFormer.py``, ``models/modules.py``), ``gnn.arch:
dygformer``.

It scores pairs, not root slots: each (src, dst) and each (src, negative)
of a batch gets its own pass through the encoder, because one of its
four channels depends on the pair.  Per scored pair (u, v) at the event's
time, from the packer's per-event histories (ops/wire.py::HistoryWire):

  1. each end w gets a sequence of L tokens: w itself (edge row "none",
     Δt 0), its L - 1 latest interactions earlier in the stream, oldest
     first (other end, edge row, t - t_edge), then padding;
  2. co-occurrence: for each position of u's sequence, how often its node
     appears in u's sequence and in v's (v's alike); padding counts 0;
     each count c goes through Linear(C→C)(ReLU(Linear(1→C)(c))) and the
     two count channels are summed;
  3. four channels of width C, each a Linear of ``patch`` tokens'
     features: the node's raw features (the stream has none: zero rows of
     ``node_dim``, as DyGLib pads them), the edge features (zero for the
     end itself and padding), cos(w·Δt + b) (``ops/time_encode``; zero at
     padding), and the co-occurrence encoding;
  4. u's and v's tokens side by side, the channels concatenated: width
     D = 4C;
  5. ``layers`` pre-LayerNorm Transformer layers, no attention mask (the
     padding takes part, as in DyGLib): x += drop(MHA(LN(x))) with dropout
     on the attention probabilities, x += drop(W2 drop(GELU(W1 LN(x))));
  6. the mean over each end's tokens, then Linear(D→node_dim): h_u, h_v;
  7. the logit fc2(ReLU(fc1([h_u ‖ h_v]))) (DyGLib's ``MergeLayer``).

The loss (``pair_bce_loss``) is the mean binary cross-entropy over the
batch's positive and negative logits.  In training each layer draws its
dropout masks from the engine's generator over the padded pair grid, in
the order models/init.py writes down.  Plain torch; no kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.time_encode import TimeEncode
from .init import _uniform, dropout, linear_default


class DyGFormerConfig(NamedTuple):
    """DyGFormer's sizes (``gnn`` keys in parentheses)."""

    node_dim: int        # node feature width (node_feat_dim)
    edge_dim: int        # the stream's edge feature width
    time_dim: int        # the time encoding's width (dim_time)
    channel: int         # C, each channel's width (channel_embedding_dim)
    patch: int           # tokens a patch (patch_size)
    seq_len: int         # L, tokens of an end (max_input_sequence_length)
    layers: int          # Transformer layers (layer)
    heads: int           # attention heads (att_head)
    drop: float          # train.dropout
    att_drop: float      # train.att_dropout

    @property
    def width(self) -> int:
        """D, a token's width: four channels."""
        return 4 * self.channel

    @property
    def history(self) -> int:
        """Interactions an end's sequence holds besides the end."""
        return self.seq_len - 1


def check_config(cfg: DyGFormerConfig) -> None:
    if cfg.seq_len < 2 or cfg.seq_len % cfg.patch:
        raise ValueError(f"gnn.max_input_sequence_length ({cfg.seq_len}) "
                         f"must be at least 2 and a multiple of "
                         f"gnn.patch_size ({cfg.patch})")
    if cfg.width % cfg.heads:
        raise ValueError(f"the token width 4 x {cfg.channel} must be a "
                         f"multiple of gnn.att_head ({cfg.heads})")


class Channels(nn.Module):
    """The four projections of a patch's features to C."""

    def __init__(self, cfg: DyGFormerConfig, generator):
        super().__init__()
        p, C = cfg.patch, cfg.channel
        self.node = linear_default(p * cfg.node_dim, C, generator)
        self.edge = linear_default(p * cfg.edge_dim, C, generator)
        self.time = linear_default(p * cfg.time_dim, C, generator)
        self.cooc = linear_default(p * C, C, generator)


class Cooccurrence(nn.Module):
    """A count's encoding: Linear(C→C)(ReLU(Linear(1→C)(c)))."""

    def __init__(self, C: int, generator):
        super().__init__()
        self.fc1 = linear_default(1, C, generator)
        self.fc2 = linear_default(C, C, generator)

    def forward(self, counts: torch.Tensor) -> torch.Tensor:
        """(..., 2) counts -> (..., C), the two count channels summed."""
        h = self.fc2(torch.relu(self.fc1(counts[..., None])))
        return h.sum(dim=-2)


class EncoderLayer(nn.Module):
    """One pre-LayerNorm Transformer layer (DyGLib ``TransformerEncoder``:
    torch's MultiheadAttention, its in-projection xavier-uniform and its
    biases zero, and a 4x feed-forward)."""

    def __init__(self, D: int, generator):
        super().__init__()
        self.norm1 = nn.LayerNorm(D)
        self.qkv = nn.utils.skip_init(nn.Linear, D, 3 * D)
        bound = math.sqrt(6.0 / (D + 3 * D))
        with torch.no_grad():
            self.qkv.weight.copy_(_uniform((3 * D, D), bound, generator))
            self.qkv.bias.zero_()
        self.out = linear_default(D, D, generator)
        with torch.no_grad():
            self.out.bias.zero_()
        self.norm2 = nn.LayerNorm(D)
        self.fc1 = linear_default(D, 4 * D, generator)
        self.fc2 = linear_default(4 * D, D, generator)


class MergeLayer(nn.Module):
    """DyGLib's link scorer: fc2(ReLU(fc1([h_u ‖ h_v])))."""

    def __init__(self, dim: int, generator):
        super().__init__()
        self.fc1 = linear_default(2 * dim, dim, generator)
        self.fc2 = linear_default(dim, 1, generator)

    def forward(self, h_u: torch.Tensor, h_v: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(torch.cat([h_u, h_v],
                                                      dim=-1))))[..., 0]


class DyGFormer(nn.Module):
    """The parameters, by the names the plain reference gives them:
    ``time`` (w, b), ``cooc``, ``proj`` (node, edge, time, cooc),
    ``layers.<i>`` (norm1, qkv, out, norm2, fc1, fc2), ``output`` and
    ``pred`` (fc1, fc2); on the CPU, drawn from ``generator`` in that
    order (models/init.py)."""

    def __init__(self, cfg: DyGFormerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.time = TimeEncode(cfg.time_dim)
        self.cooc = Cooccurrence(cfg.channel, generator)
        self.proj = Channels(cfg, generator)
        self.layers = nn.ModuleList(EncoderLayer(cfg.width, generator)
                                    for _ in range(cfg.layers))
        self.output = linear_default(cfg.width, cfg.node_dim, generator)
        self.pred = MergeLayer(cfg.node_dim, generator)


# ------------------------------------------------------------- the tokens
def end_sequences(wire):
    """Each end's sequence, (B, E, L) each: node ids (-1 at padding), edge
    rows (-1 for the end itself and at padding), Δt and validity."""
    nid, n = wire.hist_nid, wire.hist_len
    B, E, K = nid.shape
    dev = nid.device
    ids = torch.cat([wire.ev_end[..., None], nid], dim=-1)
    eid = torch.cat([torch.full((B, E, 1), -1, dtype=torch.int32,
                                device=dev), wire.hist_eid], dim=-1)
    dt = torch.cat([torch.zeros((B, E, 1), device=dev), wire.hist_dt],
                   dim=-1)
    valid = torch.arange(K + 1, device=dev) <= n[..., None]
    return ids, eid, dt, valid


def pairs_of(x: torch.Tensor):
    """(u's, v's) of every pair from a per-end (B, E, ...) tensor: the pairs
    run over the other end first, (src, dst) of every event, then (src,
    negative j) for j = 1..M, each of P = B (E - 1) rows."""
    B, E = x.shape[:2]
    rest = x.shape[2:]
    u = x[:, :1].expand(B, E - 1, *rest).transpose(0, 1)
    v = x[:, 1:].transpose(0, 1)
    return u.reshape(B * (E - 1), *rest), v.reshape(B * (E - 1), *rest)


def cooccurrence_counts(a, a_ok, b, b_ok) -> torch.Tensor:
    """(P, L, 2): for each position of the sequences ``a``, how often its
    node appears among the valid positions of ``a`` and of ``b``; 0 at
    ``a``'s padding."""
    in_a = ((a[:, :, None] == a[:, None, :]) & a_ok[:, None, :]).sum(dim=-1)
    in_b = ((a[:, :, None] == b[:, None, :]) & b_ok[:, None, :]).sum(dim=-1)
    counts = torch.stack([in_a, in_b], dim=-1).to(torch.float32)
    return torch.where(a_ok[..., None], counts, 0.0)


def _patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(..., L, F) -> (..., L / patch, patch F)."""
    *lead, L, F_ = x.shape
    return x.reshape(*lead, L // patch, patch * F_)


def pair_tokens(model: DyGFormer, wire, node_feats: torch.Tensor,
                edge_feats: torch.Tensor) -> torch.Tensor:
    """The (P, 2 L / patch, D) token grid of every pair of a history wire:
    the ends' features, time encodings and their three projections (per
    end, then selected into pairs), the co-occurrence counts of each pair
    and their encoding and projection."""
    cfg = model.cfg
    ids, eid, dt, valid = end_sequences(wire)
    ok = valid[..., None]
    node = torch.where(ok, node_feats[ids.clamp_min(0).long()], 0.0)
    edge = torch.where((eid >= 0)[..., None],
                       edge_feats[eid.clamp_min(0).long()], 0.0)
    time = torch.where(ok, model.time(dt), 0.0)
    p = cfg.patch
    chans = [model.proj.node(_patches(node, p)),
             model.proj.edge(_patches(edge, p)),
             model.proj.time(_patches(time, p))]
    a_ids, b_ids = pairs_of(ids)
    a_ok, b_ok = pairs_of(valid)
    co_a = model.cooc(cooccurrence_counts(a_ids, a_ok, b_ids, b_ok))
    co_b = model.cooc(cooccurrence_counts(b_ids, b_ok, a_ids, a_ok))
    tokens = []
    for c in chans:
        u, v = pairs_of(c)
        tokens.append(torch.cat([u, v], dim=1))
    tokens.append(torch.cat([model.proj.cooc(_patches(co_a, p)),
                             model.proj.cooc(_patches(co_b, p))], dim=1))
    return torch.cat(tokens, dim=-1)


# ------------------------------------------------------------ the encoder
def encoder_layer(lyr: EncoderLayer, x: torch.Tensor, heads: int,
                  drop: float, att_drop: float,
                  generator: Optional[torch.Generator],
                  train: bool) -> torch.Tensor:
    """One layer over (P, T, D) tokens; in training its four masks are
    drawn in the order: attention probabilities, attention output,
    feed-forward hidden, feed-forward output."""
    P, T, D = x.shape
    dh = D // heads
    h = F.layer_norm(x, (D,), lyr.norm1.weight, lyr.norm1.bias)
    q, k, v = F.linear(h, lyr.qkv.weight, lyr.qkv.bias).split(D, dim=-1)
    q, k, v = (z.reshape(P, T, heads, dh).transpose(1, 2) for z in (q, k, v))
    att = torch.softmax((q * math.sqrt(1.0 / dh)) @ k.transpose(-1, -2),
                        dim=-1)
    att = dropout(att, att_drop, generator, not train)
    o = (att @ v).transpose(1, 2).reshape(P, T, D)
    x = x + dropout(lyr.out(o), drop, generator, not train)
    h = F.gelu(lyr.fc1(F.layer_norm(x, (D,), lyr.norm2.weight,
                                    lyr.norm2.bias)))
    h = lyr.fc2(dropout(h, drop, generator, not train))
    return x + dropout(h, drop, generator, not train)


def encode_pairs(model: DyGFormer, tokens: torch.Tensor, train: bool,
                 generator: Optional[torch.Generator] = None):
    """(h_u, h_v), each (P, node_dim): the layers over the tokens, the mean
    over each end's tokens and the output layer."""
    cfg = model.cfg
    x = tokens
    for lyr in model.layers:
        x = encoder_layer(lyr, x, cfg.heads, cfg.drop, cfg.att_drop,
                          generator, train)
    T = x.shape[1] // 2
    return model.output(x[:, :T].mean(dim=1)), model.output(
        x[:, T:].mean(dim=1))


def split_logits(logits: torch.Tensor, B: int):
    """(pos (B,), neg (B, M)) from the P = B (1 + M) pair logits."""
    return logits[:B], logits[B:].reshape(-1, B).t()


def pair_bce_loss(pos: torch.Tensor, neg: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of the valid events' positive (label 1) and
    negative (label 0) logits, the mean over all of them (DyGLib's
    ``BCELoss`` over the concatenated probabilities, from the logits)."""
    w = valid.to(pos.dtype)
    lp = F.binary_cross_entropy_with_logits(pos, torch.ones_like(pos),
                                            reduction="none")
    ln = F.binary_cross_entropy_with_logits(neg, torch.zeros_like(neg),
                                            reduction="none")
    total = (lp * w).sum() + (ln * w[:, None]).sum()
    return total / (w.sum() * (1 + neg.shape[1])).clamp_min(1.0)
