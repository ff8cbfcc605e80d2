"""Segment reductions for sparse temporal-graph aggregation, and the dense
masked row softmax: the port's counterpart of
tgb_tgn_dgl_tpu/ops/segment.py, in plain torch.

The six segment reductions (``segment_sum``, ``segment_max``,
``segment_mean``, ``segment_argmax``, ``segment_last``,
``segment_softmax``) replace the reference's foreign scatter kernels
(torch_scatter ``scatter_max``, modules/msg_agg.py:12,17; PyG ``scatter``,
modules/memory_module.py:176; DGL's ``edge_softmax``, model_utils.py:597).
Each takes a static ``num_segments``, and masks stand in for ragged
filtering.  No Engine path calls them: the packed attention runs over a
dense (R, Kp) grid with ``masked_softmax`` (ops/attention.py's plain
version is built on it).  Empty segments follow the JAX ops: a sum of 0,
a max of -inf (an integer dtype's lowest value).
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def _index(segment_ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``segment_ids`` broadcast over the trailing dims of ``data``."""
    ids = segment_ids.long()
    return ids.reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    low = (float("-inf") if data.dtype.is_floating_point
           else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments, *data.shape[1:]), low)
    return out.scatter_reduce_(0, _index(segment_ids, data), data, "amax",
                               include_self=True)


def _segment_min(data, segment_ids, num_segments):
    high = (float("inf") if data.dtype.is_floating_point
            else torch.iinfo(data.dtype).max)
    out = data.new_full((num_segments, *data.shape[1:]), high)
    return out.scatter_reduce_(0, _index(segment_ids, data), data, "amin",
                               include_self=True)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-reduce rows by segment (reference MeanAggregator,
    modules/msg_agg.py:24-26) over the ``mask``-ed rows; empty segments
    give zeros."""
    if mask is not None:
        m = mask[..., None] if data.dim() > 1 else mask
        data = torch.where(m, data, torch.zeros_like(data))
        ones = mask.to(data.dtype)
    else:
        ones = data.new_ones(data.shape[:1])
    s = segment_sum(data, segment_ids, num_segments)
    c = torch.clamp(segment_sum(ones, segment_ids, num_segments), min=1)
    return s / c[..., None] if data.dim() > 1 else s / c


def segment_argmax(key: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, mask: Optional[torch.Tensor] = None,
                   tie: str = "last"):
    """Per-segment max of ``key`` and its index, with a defined tie rule:
    ``tie='last'`` keeps the highest index (insertion recency, the
    reference's e_id-recency convention, neighbor_loader.py:99), 'first'
    the lowest.  Returns (values, int32 argmax); an empty segment gets
    value -inf and argmax n with 'last', the int32 maximum with 'first'
    (as the JAX op: out of range either way)."""
    n = key.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    key = key.to(torch.float32)
    if mask is not None:
        key = torch.where(mask, key, torch.full_like(key, _NEG))
    seg_max = segment_max(key, segment_ids, num_segments)
    is_max = key >= seg_max[segment_ids.long()]
    if mask is not None:
        is_max = is_max & mask
    if tie == "last":
        cand = torch.where(is_max, idx, torch.full_like(idx, -1))
        arg = segment_max(cand, segment_ids, num_segments)
        arg = torch.where(arg < 0, torch.full_like(arg, n), arg)
    else:
        cand = torch.where(is_max, idx, torch.full_like(idx, n))
        arg = _segment_min(cand, segment_ids, num_segments)
    return seg_max, arg


def segment_last(msg: torch.Tensor, segment_ids: torch.Tensor,
                 t: torch.Tensor, num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Last-message aggregation: per segment the row of ``msg`` with the
    largest ``t`` (ties: the highest index), reference LastAggregator
    (modules/msg_agg.py:15-21); empty segments give zeros."""
    _, arg = segment_argmax(t, segment_ids, num_segments, mask=mask,
                            tie="last")
    valid = arg < msg.shape[0]
    out = msg[torch.clamp(arg, max=msg.shape[0] - 1)]
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax over edges grouped by destination
    segment, DGL's ``edge_softmax`` (reference model_utils.py:597).
    ``logits`` is (E,) or (E, H); masked-out edges get weight 0."""
    orig_dtype = logits.dtype
    x = logits.to(torch.float32)
    m = None
    if mask is not None:
        m = mask if x.dim() == 1 else mask[:, None]
        x = torch.where(m, x, torch.full_like(x, _NEG))
    seg_max = segment_max(x, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ids = segment_ids.long()
    x = torch.exp(x - seg_max[ids])
    if m is not None:
        x = torch.where(m, x, torch.zeros_like(x))
    denom = segment_sum(x, segment_ids, num_segments)
    out = x / torch.clamp(denom[ids], min=1e-16)
    return out.to(orig_dtype)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Row softmax over ``dim`` with validity ``mask`` (broadcastable):
    masked entries get weight 0, a fully masked row gives all zeros."""
    orig_dtype = logits.dtype
    x = torch.where(mask, logits.to(torch.float32), _NEG)
    x = x - torch.amax(x, dim=dim, keepdim=True).detach()
    ex = torch.where(mask, torch.exp(x), 0.0)
    denom = torch.clamp(torch.sum(ex, dim=dim, keepdim=True), min=1e-16)
    return (ex / denom).to(orig_dtype)
