"""TGN node memory, functional mailbox design — the port's counterpart of
tgb_tgn_dgl_tpu/models/memory.py, with the same names.

The node memory is a state of seven tensors (``MemoryState``), each with
N+1 rows: row N is the trash row that padded read and write targets hit,
re-zeroed after every commit.  A node's mailbox holds S slots of raw
message ids (src, dst, t, event row) — the TGL ``memory.mailbox_size``
knob (reference config/TGN.yml:15).  Messages are computed lazily, when
the mail is applied, from the current memory (reference
modules/memory_module.py:193-207).

Protocol per batch (train and eval share it):

  1. ``apply_mail``: for the batch's read set ``uniq_nid`` (from the host
     packer: event endpoints, negatives, cache neighbors), build the
     messages mem[src] ⊕ mem[dst] ⊕ raw ⊕ cos-enc(t − last_update) of the
     valid slots, combine them (the one slot for S = 1, the latest event
     for 'last', the mean for 'mean'), and run the GRU/RNN cell: (U, D)
     rows with their pending mail applied.  Gradients reach the cell and
     the time encoder through these rows for this one step (one-step
     truncated BPTT, reference modules/memory_module.py:112-114).
  2. the embedding reads those rows (``tgnn_embed(..., local=True)``);
  3. ``commit``: scatter the rows back, clear the read set's mail, then
     write the batch's events as new mail through the host's write plan
     (unique (node, slot) pairs apart from the trash row).

``commit`` writes into the state's tensors in place and returns the
state; ``Engine`` calls it after ``loss.backward()`` with the rows
detached, so no tensor that autograd saved is modified.  Index tensors
arrive as int32 and are widened with ``.long()`` before indexing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.recurrent import CELLS
from ..ops.time_encode import TimeEncode

COMBINES = ("last", "mean")


class MemoryModelConfig(NamedTuple):
    num_nodes: int
    raw_msg_dim: int
    memory_dim: int = 100        # memory.dim_out
    time_dim: int = 100          # memory.dim_time
    mailbox_size: int = 1        # memory.mailbox_size (S)
    updater: str = "gru"         # memory.memory_update: 'gru' | 'rnn'
    combine: str = "last"        # memory.mail_combine: 'last' | 'mean'

    @property
    def msg_dim(self) -> int:
        """IdentityMessage layout: mem_src ⊕ mem_dst ⊕ raw ⊕ Δt-enc
        (reference modules/msg_func.py:12-18)."""
        return 2 * self.memory_dim + self.raw_msg_dim + self.time_dim


class MemoryState(NamedTuple):
    """Device state; every tensor has N+1 rows (row N = trash)."""

    mem: torch.Tensor          # (N+1, D) float32
    last_update: torch.Tensor  # (N+1,) float32
    mail_src: torch.Tensor     # (N+1, S) int32 — keyed node
    mail_dst: torch.Tensor     # (N+1, S) int32 — event partner
    mail_t: torch.Tensor       # (N+1, S) float32
    mail_eid: torch.Tensor     # (N+1, S) int32 — dataset msg-table row
    mail_valid: torch.Tensor   # (N+1, S) bool


class Memory(nn.Module):
    """The memory's parameters, as the JAX ``params["memory"]`` subtree:
    ``time`` (a second TimeEncode, for the message's Δt) and ``cell``."""

    def __init__(self, time: TimeEncode, cell: nn.Module):
        super().__init__()
        self.time = time
        self.cell = cell


def check_cell(updater: str, combine: str) -> None:
    """The cell and the mail combine of a memory, lazy or eager."""
    if updater not in CELLS:
        raise ValueError(f"unknown memory_update {updater!r}; expected "
                         f"one of {sorted(CELLS)}")
    if combine not in COMBINES:
        raise ValueError(f"unknown mail_combine {combine!r}; expected "
                         f"one of {list(COMBINES)}")


def check_mailbox(mailbox_size: int) -> None:
    if mailbox_size < 1:
        raise ValueError(f"mailbox_size must be >= 1, got {mailbox_size}")


def check_config(cfg: MemoryModelConfig) -> None:
    check_cell(cfg.updater, cfg.combine)
    check_mailbox(cfg.mailbox_size)


def init_memory(cfg: MemoryModelConfig,
                generator: Optional[torch.Generator] = None) -> Memory:
    """The memory's parameters on the CPU: the TGL time-encoding ladder
    and the cell's U(±1/sqrt(D)) leaves drawn from ``generator``."""
    check_config(cfg)
    return Memory(TimeEncode(cfg.time_dim),
                  CELLS[cfg.updater](cfg.msg_dim, cfg.memory_dim, generator))


def init_memory_state(cfg: MemoryModelConfig, device=None) -> MemoryState:
    """Zeros, like ``reset_memory``/PyG ``reset_state`` (reference
    model_utils.py:273-288, modules/memory_module.py:103-110)."""
    n1, s = cfg.num_nodes + 1, cfg.mailbox_size

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MemoryState(
        mem=z((n1, cfg.memory_dim), torch.float32),
        last_update=z((n1,), torch.float32),
        mail_src=z((n1, s), torch.int32),
        mail_dst=z((n1, s), torch.int32),
        mail_t=z((n1, s), torch.float32),
        mail_eid=z((n1, s), torch.int32),
        mail_valid=z((n1, s), torch.bool),
    )


def apply_mail(memory: Memory, cfg: MemoryModelConfig, state: MemoryState,
               uniq_nid: torch.Tensor, feats_table: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Updated memory rows for the read set ``uniq_nid`` (U,), padded with
    N: returns (mem_rows (U, D), lu_rows (U,)), the rows WITH their
    pending mail applied; rows without mail pass through unchanged."""
    nid = uniq_nid.long()
    ms = state.mail_src[nid]             # (U, S)
    md = state.mail_dst[nid]
    mt = state.mail_t[nid]
    me = state.mail_eid[nid]
    mv = state.mail_valid[nid]
    lu = state.last_update[nid]          # (U,)
    h = state.mem[nid]                   # (U, D)

    # IdentityMessage: mem[src] ⊕ mem[dst] ⊕ raw ⊕ enc(t − last_update[src])
    # (reference modules/msg_func.py:12-18, memory_module.py:193-207)
    raw = feats_table[me.long().clamp(0, feats_table.shape[0] - 1)]
    msg = torch.cat([state.mem[ms.long()], state.mem[md.long()], raw,
                     memory.time(mt - lu[:, None])], dim=-1)  # (U, S, M)

    if cfg.mailbox_size == 1:
        # one slot IS the last (and the mean) message
        agg = msg[:, 0]
    elif cfg.combine == "last":
        # the latest event by id (the global event counter is time-ordered;
        # argmax takes the first of ties, as jnp.argmax does)
        sel = torch.where(mv, me, -1).argmax(dim=1)          # (U,)
        agg = msg[torch.arange(msg.shape[0], device=msg.device), sel]
    elif cfg.combine == "mean":
        w = mv.to(msg.dtype)
        denom = w.sum(dim=1, keepdim=True).clamp(min=1.0)
        agg = (msg * w[..., None]).sum(dim=1) / denom
    else:
        raise ValueError(f"unknown mail_combine {cfg.combine!r}")

    upd = memory.cell(agg, h)                                # (U, D)
    has = mv.any(dim=1)
    mem_rows = torch.where(has[:, None], upd, h)
    newest = torch.where(mv, mt, float("-inf")).amax(dim=1)
    lu_rows = torch.where(has, newest, lu)
    return mem_rows, lu_rows


@torch.no_grad()
def commit(cfg: MemoryModelConfig, state: MemoryState,
           uniq_nid: torch.Tensor, mem_rows: torch.Tensor,
           lu_rows: torch.Tensor, mw_node: torch.Tensor,
           mw_slot: torch.Tensor, mw_partner: torch.Tensor,
           mw_t: torch.Tensor, mw_eid: torch.Tensor) -> MemoryState:
    """Scatter the updated rows, clear the read set's mail, write the new
    mail; in place, returns ``state``.

    A node may stand in ``uniq_nid`` more than once (device-cache mode's
    read set, ops/lean_wire.py::expand_lean, repeats a node as a root and
    in every cache cell that holds it); each copy then carries the same
    row, since apply_mail computed it from the same state, so the order
    of the duplicate writes cannot matter.  The (node, slot) pairs of the
    write plan (``mw_*``, W entries, invalid ones at node N) are unique by
    host construction.  Only the trash row N takes writes of different
    values, which may race; it is re-zeroed after every scatter.
    Clearing comes before writing: the write-plan nodes are in the read
    set."""
    n = cfg.num_nodes
    nid = uniq_nid.long()
    wn, ws = mw_node.long(), mw_slot.long()
    state.mem[nid] = mem_rows.to(state.mem.dtype)
    state.last_update[nid] = lu_rows.to(state.last_update.dtype)
    # No Python scalar on the right of an indexed assignment: on CUDA it
    # is copied from host memory, which waits for the stream to drain.
    # index_fill_ and zero_ pass the value as a kernel argument.
    state.mail_valid.index_fill_(0, nid, False)
    state.mail_valid[wn, ws] = torch.ones_like(wn, dtype=torch.bool)
    state.mail_src[wn, ws] = mw_node.to(torch.int32)
    state.mail_dst[wn, ws] = mw_partner.to(torch.int32)
    state.mail_t[wn, ws] = mw_t.to(torch.float32)
    state.mail_eid[wn, ws] = mw_eid.to(torch.int32)
    for t in state:
        t[n].zero_()
    return state
