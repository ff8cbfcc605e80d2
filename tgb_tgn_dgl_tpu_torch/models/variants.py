"""Memory-model variants, DyRep and JODIE — the port's counterpart of
tgb_tgn_dgl_tpu/models/variants.py, with the same names.

  * DyRep's memory (reference modules/memory_module.py:218-421): the TGN
    mailbox memory, except that a message may hold the *embedding* of the
    event's endpoints instead of their memory (``use_src_emb`` /
    ``use_dst_emb``), with an RNN cell by default.  An embedding is a
    transient of the batch that computed it, so the message cannot be
    rebuilt lazily when the mail is applied as ``models/memory.py`` does:
    the mailbox stores the computed (S, mail_dim) message vectors
    (EAGER mail), written at the event's own batch.
  * ``TimeEmbedding`` (reference modules/emb_module.py:32-52): JODIE's
    time projection z = mem · (1 + Linear(Δt)), weight normal(0, 1/√D),
    zero bias.

The eager state has N+1 rows like ``MemoryState`` (row N is the trash row
that padded reads and writes hit).  ``eager_commit`` writes it in place,
after ``loss.backward()`` and on detached values, as ``memory.commit``
does.  Plain torch; no kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.recurrent import CELLS
from ..ops.time_encode import TimeEncode
from .memory import check_cell, check_mailbox


class EagerMemoryConfig(NamedTuple):
    num_nodes: int
    mail_dim: int                 # stored message width
    memory_dim: int = 100
    updater: str = "rnn"          # DyRep/JODIE default (reference :259-264)
    combine: str = "last"
    # The stored message is cat(self field, partner field, raw, Δt-enc);
    # each field is the node's memory, or its batch embedding when
    # toggled (reference modules/memory_module.py:266-267, 387-408).
    use_src_emb: bool = False     # self field    <- use_src_emb_in_msg
    use_dst_emb: bool = False     # partner field <- use_dst_emb_in_msg


class EagerMemoryState(NamedTuple):
    """Device state; every tensor has N+1 rows (row N = trash)."""

    mem: torch.Tensor          # (N+1, D) float32
    last_update: torch.Tensor  # (N+1,) float32
    mail: torch.Tensor         # (N+1, S, mail_dim) float32, computed
    mail_t: torch.Tensor       # (N+1, S) float32
    mail_eid: torch.Tensor     # (N+1, S) int32
    mail_valid: torch.Tensor   # (N+1, S) bool


class EagerMemory(nn.Module):
    """The eager memory's parameters, as the JAX ``params["memory"]``
    subtree of DyRep: the ``cell`` alone (the message's Δt is encoded by
    the model's own ``time``)."""

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.cell = cell


def init_eager_memory(cfg: EagerMemoryConfig,
                      generator: Optional[torch.Generator] = None
                      ) -> EagerMemory:
    """The cell's U(±1/sqrt(D)) leaves drawn from ``generator``."""
    check_cell(cfg.updater, cfg.combine)
    return EagerMemory(CELLS[cfg.updater](cfg.mail_dim, cfg.memory_dim,
                                          generator))


def init_eager_memory_state(cfg: EagerMemoryConfig, mailbox_size: int = 1,
                            device=None) -> EagerMemoryState:
    """Zeros, with ``mailbox_size`` (S) slots a node."""
    check_mailbox(mailbox_size)
    n1, s = cfg.num_nodes + 1, mailbox_size

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EagerMemoryState(
        mem=z((n1, cfg.memory_dim), torch.float32),
        last_update=z((n1,), torch.float32),
        mail=z((n1, s, cfg.mail_dim), torch.float32),
        mail_t=z((n1, s), torch.float32),
        mail_eid=z((n1, s), torch.int32),
        mail_valid=z((n1, s), torch.bool),
    )


def eager_apply_mail(memory: EagerMemory, cfg: EagerMemoryConfig,
                     state: EagerMemoryState, uniq_nid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mem_rows (U, D), lu_rows (U,)) of the read set ``uniq_nid`` with
    the pending stored mail applied; rows without mail pass through."""
    nid = uniq_nid.long()
    mail = state.mail[nid]               # (U, S, F)
    mt = state.mail_t[nid]
    me = state.mail_eid[nid]
    mv = state.mail_valid[nid]
    h = state.mem[nid]
    lu = state.last_update[nid]
    if mail.shape[1] == 1:
        # one slot IS the last (and the mean) message; a slot without mail
        # only feeds the masked-out update
        agg = mail[:, 0]
    elif cfg.combine == "last":
        # the latest event by id; argmax takes the first of ties, as
        # jnp.argmax does
        sel = torch.where(mv, me, -1).argmax(dim=1)
        agg = mail[torch.arange(mail.shape[0], device=mail.device), sel]
    else:
        w = mv.to(mail.dtype)
        denom = w.sum(dim=1, keepdim=True).clamp(min=1.0)
        agg = (mail * w[..., None]).sum(dim=1) / denom
    upd = memory.cell(agg, h)
    has = mv.any(dim=1)
    mem_rows = torch.where(has[:, None], upd, h)
    newest = torch.where(mv, mt, float("-inf")).amax(dim=1)
    lu_rows = torch.where(has, newest, lu)
    return mem_rows, lu_rows


@torch.no_grad()
def eager_commit(cfg: EagerMemoryConfig, state: EagerMemoryState,
                 uniq_nid: torch.Tensor, mem_rows: torch.Tensor,
                 lu_rows: torch.Tensor, mw_node: torch.Tensor,
                 mw_slot: torch.Tensor, mw_mail: torch.Tensor,
                 mw_t: torch.Tensor, mw_eid: torch.Tensor
                 ) -> EagerMemoryState:
    """Scatter the updated rows, clear the read set's mail, write the new
    mail ``mw_mail`` (W, mail_dim) at the write plan's (node, slot) pairs;
    in place, returns ``state``.  The pairs are unique apart from the
    trash row N, which is re-zeroed after the writes (as
    ``memory.commit``); clearing comes before writing, since the
    write-plan nodes are in the read set."""
    n = cfg.num_nodes
    nid = uniq_nid.long()
    wn, ws = mw_node.long(), mw_slot.long()
    state.mem[nid] = mem_rows.to(state.mem.dtype)
    state.last_update[nid] = lu_rows.to(state.last_update.dtype)
    # no Python scalar on the right of an indexed assignment: on CUDA it
    # is copied from host memory and waits for the stream (memory.commit)
    state.mail_valid.index_fill_(0, nid, False)
    state.mail_valid[wn, ws] = torch.ones_like(wn, dtype=torch.bool)
    state.mail[wn, ws] = mw_mail.to(state.mail.dtype)
    state.mail_t[wn, ws] = mw_t.to(torch.float32)
    state.mail_eid[wn, ws] = mw_eid.to(torch.int32)
    for t in state:
        t[n].zero_()
    return state


@torch.no_grad()
def dyrep_messages(cfg: EagerMemoryConfig, embed: torch.Tensor, pack,
                   feats_table: torch.Tensor, time: TimeEncode,
                   mem_rows: torch.Tensor, lu_rows: torch.Tensor
                   ) -> torch.Tensor:
    """The eager mail of the batch's write plan, (W = 2B, mail_dim): for
    write (node <- event), cat(self field, partner field, raw message,
    cos-enc(t - last_update[self])), the reference's IdentityMessage
    layout (modules/msg_func.py:12-18).  A field is the node's post-apply
    memory row (``mem_rows`` (U, D), through ``pack.root_loc``) or, with
    ``cfg.use_src_emb`` (self) / ``cfg.use_dst_emb`` (partner), its
    embedding ``embed`` (R, D) in this batch; ``time`` is the model's
    time encoder.  Both endpoints of an event are roots, so both slots
    exist.  ``pack.root_loc`` must cover every slot of ``embed`` (the
    slot-unique eval hands the full (R2,) map, not one embed chunk's).

    Write 2i is the source's (self slot ``ev_src_slot[i]``, partner
    ``ev_pos_slot[i]``), write 2i+1 the destination's (swapped)."""
    B = pack.ev_src_slot.shape[0]
    src_slot = pack.ev_src_slot.long()
    pos_slot = pack.ev_pos_slot.long()
    self_slot = torch.stack([src_slot, pos_slot], dim=1).reshape(2 * B)
    partner_slot = torch.stack([pos_slot, src_slot], dim=1).reshape(2 * B)
    root_loc = pack.root_loc.long()
    self_loc = root_loc[self_slot]
    f_self = embed[self_slot] if cfg.use_src_emb else mem_rows[self_loc]
    f_partner = (embed[partner_slot] if cfg.use_dst_emb
                 else mem_rows[root_loc[partner_slot]])
    raw = feats_table[pack.mw_eid.long().clamp(0, feats_table.shape[0] - 1)]
    te = time(pack.mw_t - lu_rows[self_loc])
    return torch.cat([f_self, f_partner, raw, te], dim=-1)


class TimeEmbedding(nn.Linear):
    """JODIE's time projection (reference modules/emb_module.py:32-52): a
    Linear(1, D), so its leaves are ``weight`` (D, 1) and ``bias`` (D,),
    the bridge's image of the JAX ``{"w": (1, D), "b": (D,)}``; called as
    ``(mem_rows, dt) -> mem_rows · (1 + dt·w + b)``."""

    def __init__(self, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(1, dim)
        with torch.no_grad():
            self.weight.copy_(torch.randn((dim, 1), generator=generator)
                              / math.sqrt(dim))
            self.bias.zero_()

    def forward(self, mem_rows: torch.Tensor,
                dt: torch.Tensor) -> torch.Tensor:
        # elementwise, as the JAX function: dt[..., None] * w[0] + b
        proj = dt[..., None] * self.weight[:, 0] + self.bias
        return mem_rows * (1.0 + proj)
