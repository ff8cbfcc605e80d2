"""TGNN — the flagship model — on torch: the port's counterpart of
tgb_tgn_dgl_tpu/models/tgnn.py, scalar and vector message modes, one to
eight stacked attention layers.

Re-design of reference model_utils.py:14-159 (TGNN), :201-237
(TimeEncode), :422-455 (TemporalEdgePreprocess), :471-612 (EdgeGATConv),
:165-195 (EdgePredictor).  The host packer (data/packer.py) resolves every
(node, block) root slot into a fixed-width row of in-edges (K cache + 1
self-loop + P intra-batch) with Δt pre-resolved, so attention is a masked
row softmax over an (R, Kp) grid: one dense pass per batch.

Parameters are the JAX package's RAW leaves (``time.w/b``,
``gat.fc_node``, ``gat.fc_edge``, ``gat.attn_l/r/e``, ``pred.*``), so the
collapse of fc ⊙ attn into (D_in → H) projections (``_fused_attn_proj``)
happens inside the autograd graph, exactly as the JAX step does; Adam then
follows the same path.  ``bridge.py`` maps them to and from the JAX
pytree.

Faithful quirks preserved: scalar per-head messages broadcast-added to the
identity residual and averaged over heads (model_utils.py:560-563,
587-599); the frozen all-ones memory (``const_ones_memory``,
model_utils.py:270-271); each source paired with its own negatives (the
reference's eval tile bug is not replicated).  ``message_mode='vector'``
is the corrected per-head vector-message attention: (R, Kp, H, D)
projections, messages ``a ⊙ (node_p + edge_p)``, head mean of
``out + dst_in``.  It runs as plain torch on both devices, as the JAX
package runs it outside Pallas; the scalar mode's softmax and weighted
sum go through ``ops/attention.attention_core`` (the CUDA kernels on the
GPU) at every layer.

``num_layers`` > 1 stacks EdgeGATConv layers over the SAME per-block
in-edge grid (the reference's commented layer stack, model_utils.py:
669-686): layer l > 1 reads, for each in-edge, the source's layer-(l-1)
embedding where the source is a root of the same dependency block
(``pack.nbr_rslot`` >= 0), else its raw node features (the zero-in-degree
identity residual, :567-577), and the roots' layer-(l-1) embeddings; its
parameters are ``gat{l}``, shaped as ``gat``.  Intermediate layers
aggregate heads by mean, as the last one does (the JAX package's
documented deviation on dead code).

``compute_dtype`` (``train.compute_dtype``) is the dtype of the dense
pass, as in the JAX embed: the edge features, the time encoding and the
node features are cast to it (the memory table before its gather, so its
gradient sums in that dtype too), the scalar mode's projections run in
it, and the head mean takes the attention output cast to it.  The
attention itself runs in fp32 on both devices (``attention_core`` casts
el′ and er, as the JAX Pallas route does before its kernels), vector
layers promote to fp32 at their fp32 parameters (as JAX's type promotion
does), and the embedding comes back in fp32.  Parameters stay fp32.

Node features come from one of three places: literal ones (the frozen
memory), a full (N, D) table gathered by node id, or (``local=True``) the
batch's (U, D) memory rows from ``models/memory.apply_mail``, gathered
through the packer's ``nbr_loc``/``root_loc`` maps.  With the mailbox
memory the model holds the memory's parameters as its ``memory``
submodule, so they share the model's state dict and optimizer, as the
JAX tree's ``params["memory"]`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn.functional import embedding

from ..data.packer import KIND_INVALID, KIND_SELF
from ..ops.attention import attention_core
from ..ops.gather import gather_rows
from ..ops.segment import masked_softmax
from ..ops.time_encode import TimeEncode
from .init import (dropout, dropout_mask, linear_default, linear_xavier,
                   xavier_normal)


class TGNNConfig(NamedTuple):
    edge_feat_dim: int
    hidden_dim: int = 100          # gnn.dim_out; also time_dim & memory_dim
    num_heads: int = 8             # gnn.att_head
    num_layers: int = 1            # gnn.layer
    message_mode: str = "scalar"   # 'scalar' (reference quirk) | 'vector'
    feat_drop: float = 0.2         # train.dropout
    attn_drop: float = 0.2         # train.att_dropout
    negative_slope: float = 0.2    # leaky_relu (model_utils.py:517)
    # the dense pass's dtype (train.compute_dtype): float32 or bfloat16
    compute_dtype: torch.dtype = torch.float32
    # frozen all-ones memory (model_utils.py:270-271): node features are
    # literal ones, no table gather
    const_ones_memory: bool = False


# the JAX embed's dropout-key budget caps the stack (tgb_tgn_dgl_tpu
# models/tgnn.py:263); the port keeps the same limit
MAX_LAYERS = 8


def check_supported(cfg: TGNNConfig) -> None:
    if cfg.message_mode not in ("scalar", "vector"):
        raise ValueError(f"message_mode={cfg.message_mode!r}: expected "
                         f"'scalar' or 'vector'")
    if not 1 <= cfg.num_layers <= MAX_LAYERS:
        raise ValueError(f"gnn.layer={cfg.num_layers}: must be within 1.."
                         f"{MAX_LAYERS}")


class GATLayer(nn.Module):
    """EdgeGATConv parameters: fc weights (H·D, in) as nn.Linear stores
    them, attention vectors (H, D)."""

    def __init__(self, fc_node: nn.Linear, fc_edge: nn.Linear,
                 attn_l: torch.Tensor, attn_r: torch.Tensor,
                 attn_e: torch.Tensor):
        super().__init__()
        self.fc_node = fc_node
        self.fc_edge = fc_edge
        self.attn_l = nn.Parameter(attn_l)
        self.attn_r = nn.Parameter(attn_r)
        self.attn_e = nn.Parameter(attn_e)


class EdgePredictor(nn.Module):
    """GraphMixer-style 2-tower scorer (reference model_utils.py:165-195):
    out_fc(relu(src_fc(h_s) + dst_fc(h_d))).  h_neg may be (B, D) or
    (B, M, D); each source pairs with its own negatives."""

    def __init__(self, src_fc: nn.Linear, dst_fc: nn.Linear,
                 out_fc: nn.Linear):
        super().__init__()
        self.src_fc = src_fc
        self.dst_fc = dst_fc
        self.out_fc = out_fc

    def forward(self, h_src, h_pos, h_neg):
        s = self.src_fc(h_src)
        p = self.dst_fc(h_pos)
        n = self.dst_fc(h_neg)
        pos = self.out_fc(torch.relu(s + p))[..., 0]
        if n.dim() == 3:
            s = s[:, None, :]
        neg = self.out_fc(torch.relu(s + n))[..., 0]
        return pos, neg


class TGNN(nn.Module):
    """``gats`` holds one GATLayer per attention layer: the first is
    ``gat``, layer l > 1 is ``gat{l}`` (the JAX tree's keys).  ``memory``
    (models/memory.Memory) is None for the frozen path."""

    def __init__(self, time: TimeEncode, gats: Sequence[GATLayer],
                 pred: EdgePredictor, memory: Optional[nn.Module] = None):
        super().__init__()
        self.time = time
        self.gat = gats[0]
        self.pred = pred
        self.memory = memory
        for l, gat in enumerate(gats[1:], start=2):
            setattr(self, f"gat{l}", gat)

    def layer(self, l: int) -> GATLayer:
        """The parameters of attention layer ``l`` (0-based)."""
        return self.gat if l == 0 else getattr(self, f"gat{l + 1}")


def init_tgnn(cfg: TGNNConfig,
              generator: Optional[torch.Generator] = None) -> TGNN:
    """Build the model on the CPU with the reference's init distributions
    (time_dim = hidden_dim, as the reference overrides its time_dim
    argument, model_utils.py:18).  Leaves are drawn in the order ``gat``,
    ``pred``, then ``gat2`` … ``gat{L}`` (models/init.py)."""
    check_supported(cfg)
    D = cfg.hidden_dim
    H = cfg.num_heads
    De = cfg.edge_feat_dim + D       # edge feat ⊕ time encoding

    def gat_layer():
        return GATLayer(
            fc_node=linear_xavier(D, H * D, generator=generator),
            fc_edge=linear_xavier(De, H * D, generator=generator),
            attn_l=xavier_normal((1, H, D), generator=generator)[0],
            attn_r=xavier_normal((1, H, D), generator=generator)[0],
            attn_e=xavier_normal((1, H, D), generator=generator)[0],
        )

    gat = gat_layer()
    pred = EdgePredictor(linear_default(D, D, generator),
                         linear_default(D, D, generator),
                         linear_default(D, 1, generator))
    # every layer has the same shapes, since memory_dim == hidden_dim
    extra = [gat_layer() for _ in range(cfg.num_layers - 1)]
    return TGNN(TimeEncode(D), [gat, *extra], pred)


def _fused_attn_proj(lin: nn.Linear, attn: torch.Tensor):
    """Collapse fc(x).view(-1,H,D) ⊙ attn → sum(-1) into x @ W_eff + b_eff.

    fc weight is (H*D, in); attn is (H, D).  Exact because the reference
    applies dropout to fc *inputs* (model_utils.py:579-589)."""
    H, D = attn.shape
    w = lin.weight.reshape(H, D, -1)
    w_eff = torch.einsum("hdi,hd->ih", w, attn)
    b_eff = torch.einsum("hd,hd->h", lin.bias.reshape(H, D), attn)
    return w_eff, b_eff


def _scalar_layer(gat: GATLayer, cfg: TGNNConfig, src_d, dst_d, ef_d, te_d,
                  mask, generator, det: bool) -> torch.Tensor:
    """One scalar-mode EdgeGATConv pass over the grid: the fused
    (D_in → H) projections, then ``attention_core`` (the kernels on CUDA),
    the identity residual and the head mean."""
    F = ef_d.shape[-1]
    cdt = cfg.compute_dtype
    wl, bl = (w.to(cdt) for w in _fused_attn_proj(gat.fc_node, gat.attn_l))
    wr, br = (w.to(cdt) for w in _fused_attn_proj(gat.fc_node, gat.attn_r))
    we, be = (w.to(cdt) for w in _fused_attn_proj(gat.fc_edge, gat.attn_e))
    el = src_d @ wl + bl                       # (R, Kp, H)
    er = dst_d @ wr + br                       # (R, H)
    ee = ef_d @ we[:F] + te_d @ we[F:] + be
    el_prime = el + ee
    dm = None
    if not det and cfg.attn_drop > 0.0:
        dm = dropout_mask(el_prime.shape, cfg.attn_drop, generator,
                          el_prime.device)
    out = attention_core(el_prime, er, mask, cfg.negative_slope,
                         drop_mask=dm)         # (R, H), fp32
    # identity residual + head mean: mean_h(out_h + dst_in_d)
    return dst_d + torch.mean(out.to(cdt), dim=-1, keepdim=True)


def _vector_layer(gat: GATLayer, cfg: TGNNConfig, src_d, dst_d, ef_d, te_d,
                  mask, generator, det: bool) -> torch.Tensor:
    """One vector-mode EdgeGATConv pass (tgb_tgn_dgl_tpu
    models/tgnn.py:240-257), plain torch: per-head (R, Kp, H, D)
    projections, logits el + ee + er, masked softmax, attention dropout,
    messages ``a ⊙ (node_p + edge_p)`` summed over the columns, and the
    head mean of ``out + dst_in``, in fp32 whatever the compute dtype
    (JAX promotes its inputs at the fp32 parameters)."""
    H, D = cfg.num_heads, cfg.hidden_dim
    src_d, dst_d, ef_d, te_d = (x.to(torch.float32)
                                for x in (src_d, dst_d, ef_d, te_d))
    F = ef_d.shape[-1]
    node_p = gat.fc_node(src_d).unflatten(-1, (H, D))     # (R, Kp, H, D)
    root_p = gat.fc_node(dst_d).unflatten(-1, (H, D))     # (R, H, D)
    w = gat.fc_edge.weight                                # (H·D, F + D)
    edge_p = (ef_d @ w[:, :F].T + te_d @ w[:, F:].T
              + gat.fc_edge.bias).unflatten(-1, (H, D))
    el = torch.sum(node_p * gat.attn_l, dim=-1)           # (R, Kp, H)
    er = torch.sum(root_p * gat.attn_r, dim=-1)           # (R, H)
    ee = torch.sum(edge_p * gat.attn_e, dim=-1)
    x = el + ee + er[:, None, :]
    logits = torch.where(x >= 0, x, x * cfg.negative_slope)
    a = masked_softmax(logits, mask[..., None], dim=1)
    a = dropout(a, cfg.attn_drop, generator, det)
    out = torch.sum(a[..., None] * (node_p + edge_p), dim=1)   # (R, H, D)
    return torch.mean(out + dst_d[:, None, :], dim=1)


def tgnn_embed(model: TGNN, cfg: TGNNConfig, memory: Optional[torch.Tensor],
               feats_table: torch.Tensor, pack, *, train: bool,
               generator: Optional[torch.Generator] = None,
               local: bool = False) -> torch.Tensor:
    """Embed every root slot of a device pack: returns (R, D).

    One dense pass a layer = TemporalEdgePreprocess (Δt encode ⊕ edge
    feat, model_utils.py:440-449) + EdgeGATConv (attention logits
    el+ee+er, leaky-relu, per-root softmax, weighted sum, residual, head
    mean, model_utils.py:565-612,688-697) across ALL dependency blocks at
    once.  ``memory`` is the (N, D) node memory, or with ``local`` the
    (U, D) rows of the batch's read set; unused (may be None) when
    ``cfg.const_ones_memory`` and not ``local``.  Above one layer the pack
    must carry ``nbr_rslot``."""
    check_supported(cfg)
    D = cfg.hidden_dim
    cdt = cfg.compute_dtype
    det = not train
    rslot = pack.nbr_rslot
    if cfg.num_layers > 1 and rslot is None:
        raise ValueError("gnn.layer > 1 needs nbr_rslot in the pack "
                         "(PackerConfig.layers = gnn.layer)")

    kind = pack.nbr_kind                       # (R, Kp) int8
    mask = kind != KIND_INVALID                # (R, Kp)
    R, Kp = kind.shape

    # ---- edge features: msg-table gather; self-loops are ones ----------
    # (the JAX embed casts the table before its gather; the table takes no
    # gradient, so casting the gathered rows gives the same values)
    feat_idx = pack.nbr_feat.long().clamp(0, feats_table.shape[0] - 1)
    ef = feats_table[feat_idx].to(cdt)         # (R, Kp, F)
    ef = torch.where((kind == KIND_SELF)[..., None], 1.0, ef)
    ef = torch.where(mask[..., None], ef, 0.0)

    # ---- Δt time encoding (TemporalEdgePreprocess) ----------------------
    te = model.time(pack.nbr_dt).to(cdt)       # (R, Kp, D)
    # The edge input is conceptually concat(ef, te) (R, Kp, F+D); every
    # consumer splits its projection into W[:F] @ ef + W[F:] @ te instead.

    # ---- node features (the table cast before its gather) -------------
    if memory is not None:
        memory = memory.to(cdt)
    if local:
        # gather_rows() is embedding(idx, memory); on CUDA its backward
        # sorts the slots by row and sums them in fixed chunks of slots,
        # each chunk a warp, so the trash row that every padded column
        # points at (57-79% of a train batch's slots) is summed by many
        # warps, and in the same order every run
        nf_src = gather_rows(pack.nbr_loc, memory)        # (R, Kp, D)
        nf_dst = gather_rows(pack.root_loc, memory)       # (R, D)
    elif cfg.const_ones_memory:
        nf_src = torch.ones((R, Kp, D), dtype=cdt, device=ef.device)
        nf_dst = torch.ones((R, D), dtype=cdt, device=ef.device)
    else:
        nf_src = memory[pack.nbr_nid.long()]   # (R, Kp, D)
        nf_dst = memory[pack.root_nid.long()]  # (R, D)

    gat_pass = (_scalar_layer if cfg.message_mode == "scalar"
                else _vector_layer)
    embed = None
    for l in range(cfg.num_layers):
        if l == 0:
            src_in, dst_in = nf_src, nf_dst
        else:
            # a source rooted in the same block reads its layer-(l-1)
            # embedding, any other its raw features; embedding() again for
            # the backward, since every -1 cell clamps to slot 0
            rs = rslot.long()
            src_in = torch.where((rs >= 0)[..., None],
                                 embedding(rs.clamp_min(0), embed), nf_src)
            dst_in = embed
        # each layer draws its masks, in this order, from one generator
        # (models/init.py)
        src_d = dropout(src_in, cfg.feat_drop, generator, det)
        dst_d = dropout(dst_in, cfg.feat_drop, generator, det)
        ef_d = dropout(ef, cfg.feat_drop, generator, det)
        te_d = dropout(te, cfg.feat_drop, generator, det)
        embed = gat_pass(model.layer(l), cfg, src_d, dst_d, ef_d, te_d, mask,
                         generator, det)
    return embed.to(torch.float32)


def tgnn_forward(model: TGNN, cfg: TGNNConfig,
                 memory: Optional[torch.Tensor], feats_table: torch.Tensor,
                 pack, *, train: bool,
                 generator: Optional[torch.Generator] = None,
                 local: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward: (pos_logits (B,), neg_logits (B,) or (B, M))."""
    embed = tgnn_embed(model, cfg, memory, feats_table, pack, train=train,
                       generator=generator, local=local)
    return model.pred(embed[pack.ev_src_slot.long()],
                      embed[pack.ev_pos_slot.long()],
                      embed[pack.ev_neg_slot.long()])


def bce_loss(pos_logits: torch.Tensor, neg_logits: torch.Tensor,
             ev_valid: torch.Tensor,
             n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCEWithLogits mean over pos + mean over neg (reference
    epoch_utils.py:295-296), masked to real (non-padded) events.
    ``n_valid`` replaces the count of real events in the denominators: a
    share of a batch's events (parallel/sharded.py) takes the batch's
    count, so that the shares' losses sum to the batch's."""
    v = ev_valid.to(torch.float32)
    pos_l = (torch.clamp(pos_logits, min=0) - pos_logits
             + torch.log1p(torch.exp(-torch.abs(pos_logits))))
    neg_l = (torch.clamp(neg_logits, min=0)
             + torch.log1p(torch.exp(-torch.abs(neg_logits))))
    count = v.sum() if n_valid is None else n_valid.to(torch.float32)
    denom = torch.clamp(count, min=1.0)
    pos_term = (pos_l * v).sum() / denom
    if neg_logits.dim() == 2:
        m = neg_logits.shape[1]
        neg_term = ((neg_l * v[:, None]).sum()
                    / torch.clamp(count * m, min=1.0))
    else:
        neg_term = (neg_l * v).sum() / denom
    return pos_term + neg_term
