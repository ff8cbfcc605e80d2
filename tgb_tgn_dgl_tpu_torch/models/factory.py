"""Model factory, the ``gnn.arch`` knob — the port's counterpart of
tgb_tgn_dgl_tpu/models/factory.py.

  arch 'transformer_attention'  TGNN's edge-attention embedding
                                (models/tgnn.py); memory optional (the
                                frozen all-ones quirk or the mailbox).
  arch 'identity'               JODIE: the embedding is the time-projected
                                memory row (models/variants.py
                                ``TimeEmbedding``), no graph attention;
                                the mailbox memory with an RNN cell.
  arch 'dyrep'                  DyRep: TGNN's attention embedding and the
                                EAGER mail memory, whose messages may hold
                                the event partner's embedding
                                (models/variants.py).
  arch 'dygformer'              DyGFormer: a Transformer over each scored
                                pair's first-hop histories
                                (models/dygformer.py); no memory.  It
                                scores pairs, not root slots, so
                                ``arch_embed`` / ``arch_predict`` do not
                                apply: the engine runs its own pair path.

``init_arch`` builds the model; the engine adds its ``memory`` submodule
and composes ``arch_embed`` / ``arch_predict`` with the memory protocol.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.functional import embedding

from ..data.packer import KIND_SELF
from .dygformer import DyGFormer, DyGFormerConfig
from .init import linear_default
from .tgnn import EdgePredictor, TGNNConfig, init_tgnn, tgnn_embed
from .variants import TimeEmbedding

ARCHS = ("transformer_attention", "identity", "dyrep", "dygformer")
# the archs whose embedding is TGNN's attention
ATTENTION_ARCHS = ("transformer_attention", "dyrep")
# the archs that score pairs from per-event histories
PAIR_ARCHS = ("dygformer",)


class Jodie(nn.Module):
    """JODIE's parameters, as the JAX tree of arch 'identity': ``jodie``
    (the time projection), ``pred`` (TGNN's ``EdgePredictor``) and, set by
    the engine, ``memory`` (models/memory.Memory)."""

    def __init__(self, jodie: TimeEmbedding, pred: EdgePredictor,
                 memory: Optional[nn.Module] = None):
        super().__init__()
        self.jodie = jodie
        self.pred = pred
        self.memory = memory


def init_arch(cfg: TGNNConfig, arch: str,
              generator: Optional[torch.Generator] = None,
              pair_cfg: Optional[DyGFormerConfig] = None) -> nn.Module:
    """The model of ``arch`` on the CPU, its leaves drawn from
    ``generator`` (models/init.py gives the order); a pair arch takes its
    sizes from ``pair_cfg``."""
    if arch in PAIR_ARCHS:
        return DyGFormer(pair_cfg, generator)
    if arch in ATTENTION_ARCHS:
        return init_tgnn(cfg, generator)
    if arch == "identity":
        D = cfg.hidden_dim
        jodie = TimeEmbedding(D, generator)
        pred = EdgePredictor(linear_default(D, D, generator),
                             linear_default(D, D, generator),
                             linear_default(D, 1, generator))
        return Jodie(jodie, pred)
    raise ValueError(f"unknown gnn.arch '{arch}' (supported: {ARCHS})")


def arch_embed(model: nn.Module, arch: str, cfg: TGNNConfig,
               memory_rows: Optional[torch.Tensor],
               lu_rows: Optional[torch.Tensor], feats_table: torch.Tensor,
               pack, *, train: bool,
               generator: Optional[torch.Generator] = None,
               local: bool) -> torch.Tensor:
    """Root-slot embeddings (R, D) for any arch.  ``memory_rows`` are the
    batch's (U, D) rows with ``local``, else as ``tgnn_embed`` takes them;
    ``lu_rows`` the (U,) last-update times (JODIE only)."""
    if arch in ATTENTION_ARCHS:
        return tgnn_embed(model, cfg, memory_rows, feats_table, pack,
                          train=train, generator=generator, local=local)
    if arch == "identity":
        if not local or lu_rows is None:
            raise ValueError("gnn.arch 'identity' (JODIE) embeds the "
                             "batch's local memory rows")
        # the self-loop column carries Δt = -clock[root] (the packer), so
        # the root's event time is minus the Δt of its KIND_SELF column
        is_self = pack.nbr_kind == KIND_SELF               # (R, Kp)
        clock_root = -(pack.nbr_dt * is_self).sum(dim=1)
        loc = pack.root_loc.long()
        # embedding() for the backward, as tgnn_embed's local read: padded
        # slots all point at one row
        mem_root = embedding(loc, memory_rows)             # (R, D)
        z = model.jodie(mem_root, clock_root - lu_rows[loc])
        return torch.where(pack.root_valid[:, None], z, 0.0)
    raise ValueError(f"unknown gnn.arch '{arch}' (supported: {ARCHS})")


def arch_predict(model: nn.Module, embed: torch.Tensor, pack):
    """(pos, neg) logits from root-slot embeddings: the shared 2-tower
    scorer ``model.pred`` (reference model_utils.py:165-195)."""
    return model.pred(embed[pack.ev_src_slot.long()],
                      embed[pack.ev_pos_slot.long()],
                      embed[pack.ev_neg_slot.long()])
