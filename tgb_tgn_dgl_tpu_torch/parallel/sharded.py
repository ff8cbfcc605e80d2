"""The sharded step's pieces over a ``Mesh`` (parallel/mesh.py): the port's
counterpart of tgb_tgn_dgl_tpu/parallel/sharded.py, whose jitted steps
(``build_sharded_train_step``, ``build_sharded_memory_train_step``) leave
the collectives to GSPMD.  Here they are written out, and
parallel/engine.py::ShardedEngine composes them into its steps:

  * a batch's root slots and events split over "dp" in contiguous shares
    (``root_share``, ``event_share``): rank (d, s) embeds rows
    [d·R/dp, (d+1)·R/dp) of the expanded pack, the (R, D) table is
    all-gathered over dp (its backward a reduce-scatter), and it scores
    events [d·B/dp, (d+1)·B/dp);
  * the node memory (``MemoryState``, N+1 rows padded to a multiple of
    the state width) row-sharded over "state" (``RowShard``): each rank
    keeps its rows and one local trash row.  ``read_for_apply`` gathers a
    batch's read set (and the mail partners' memory rows) over the state
    group, each shard giving the rows it owns, into a compact state that
    ``apply_mail`` reads exactly as it reads the whole one;
    ``commit_owned`` writes only the rows the shard owns, so the commit
    needs no collective.

Every rank of a state group holds the same wire and the same parameters,
so it computes the same read set, the same applied rows and the same
commit; the dp groups hold copies of the memory that stay equal.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.memory import MemoryState, init_memory_state
from .mesh import Mesh

# the DevicePack fields with one row per root slot (the embedding's input)
ROOT_FIELDS = ("root_nid", "root_valid", "nbr_nid", "nbr_dt", "nbr_kind",
               "nbr_feat", "root_loc", "nbr_loc", "nbr_rslot")
# the event fields the scoring reads
EVENT_FIELDS = ("ev_src_slot", "ev_pos_slot", "ev_neg_slot", "ev_valid")


def root_share(pack, mesh: Mesh):
    """The pack with its root-slot rows cut to this rank's dp share."""
    sl = mesh.share(pack.root_loc.shape[0], "dp")
    return pack._replace(**{f: getattr(pack, f)[sl] for f in ROOT_FIELDS
                            if getattr(pack, f) is not None})


def event_share(pack, mesh: Mesh):
    """The pack with its scored event fields cut to this rank's dp share
    (the slots still index the whole gathered table)."""
    sl = mesh.share(pack.ev_valid.shape[0], "dp")
    return pack._replace(**{f: getattr(pack, f)[sl] for f in EVENT_FIELDS})


class RowShard(NamedTuple):
    """This rank's rows of an ``n``-row table over "state": global rows
    [lo, lo + rows); local row ``rows`` is the shard's trash row."""
    n: int
    lo: int
    rows: int

    @classmethod
    def of(cls, n: int, mesh: Mesh) -> "RowShard":
        rows = -(-n // mesh.state)
        return cls(n, mesh.s * rows, rows)

    def local(self, nodes: torch.Tensor) -> torch.Tensor:
        """Local rows of global ``nodes``; a row of another shard maps to
        the trash row."""
        g = nodes.long() - self.lo
        return torch.where((g >= 0) & (g < self.rows), g, self.rows)

    def owner(self, nodes: torch.Tensor) -> torch.Tensor:
        return torch.div(nodes.long(), self.rows, rounding_mode="floor")


def init_sharded_memory_state(cfg, shard: RowShard, device) -> MemoryState:
    """The zero state of this shard: its rows and the trash row."""
    return init_memory_state(cfg._replace(num_nodes=shard.rows), device)


def shard_state(full: MemoryState, shard: RowShard) -> MemoryState:
    """This shard's rows (and a zero trash row) of a whole N+1-row state."""
    def cut(t):
        out = torch.zeros((shard.rows + 1, *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        rows = t[shard.lo:shard.lo + shard.rows]
        out[:rows.shape[0]] = rows
        return out

    return MemoryState(*(cut(t) for t in full))


def gather_state(local: MemoryState, shard: RowShard,
                 mesh: Mesh) -> MemoryState:
    """The whole N+1-row state from the shards, on every rank of the state
    group (a collective)."""
    return MemoryState(*(mesh.all_gather(t[:shard.rows], "state")[:shard.n]
                         for t in local))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as (rows, k) int32 columns, bit for bit."""
    t = t.reshape(t.shape[0], -1)
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    return t.view(torch.int32)


def _gather_owned(parts, nodes, shard: RowShard, mesh: Mesh):
    """Rows ``nodes`` of the fields ``parts`` (each read locally at
    ``shard.local(nodes)``; another shard's rows read as the zero trash
    row), each taken from its owner over the state group."""
    if mesh.state == 1:
        return parts
    cols = [_bits(p) for p in parts]
    widths = [c.shape[1] for c in cols]
    n = nodes.shape[0]
    allp = mesh.all_gather(torch.cat(cols, dim=1), "state")
    mine = allp.view(mesh.state, n, -1)[
        shard.owner(nodes), torch.arange(n, device=nodes.device)]
    out = []
    for p, c in zip(parts, torch.split(mine, widths, dim=1)):
        c = c.contiguous()
        out.append((c != 0 if p.dtype == torch.bool else c.view(p.dtype))
                   .reshape(p.shape))
    return out


def read_for_apply(local: MemoryState, shard: RowShard, mesh: Mesh,
                   uniq_nid: torch.Tensor):
    """(state, nid) for ``apply_mail``: with one state shard the local
    state and ``uniq_nid`` themselves; otherwise a compact state of the
    read set's U rows followed by the memory rows of their mail's nodes
    (``mail_src``, ``mail_dst``), whose mail now points at those rows, and
    nid = 0..U-1.  ``apply_mail`` reads the same values either way."""
    if mesh.state == 1:
        return local, uniq_nid
    idx = shard.local(uniq_nid)
    mem, lu, ms, md, mt, me, mv = _gather_owned(
        [t[idx] for t in local], uniq_nid, shard, mesh)
    U, S = ms.shape
    partners = torch.cat([ms.reshape(-1), md.reshape(-1)])
    (pmem,) = _gather_owned([local.mem[shard.local(partners)]], partners,
                            shard, mesh)
    at = torch.arange(U, U + 2 * U * S, dtype=torch.int32,
                      device=mem.device).view(2, U, S)
    compact = MemoryState(mem=torch.cat([mem, pmem]), last_update=lu,
                          mail_src=at[0], mail_dst=at[1], mail_t=mt,
                          mail_eid=me, mail_valid=mv)
    return compact, torch.arange(U, device=uniq_nid.device)


@torch.no_grad()
def commit_owned(local: MemoryState, shard: RowShard, uniq_nid, mem_rows,
                 lu_rows, mw_node, mw_slot, mw_partner, mw_t,
                 mw_eid) -> MemoryState:
    """models/memory.py::commit on this shard's rows only, in place: the
    rows another shard owns go to the local trash row, which is zeroed
    after, as is the global trash row N where this shard holds it."""
    nid = shard.local(uniq_nid)
    wn, ws = shard.local(mw_node), mw_slot.long()
    local.mem[nid] = mem_rows.to(local.mem.dtype)
    local.last_update[nid] = lu_rows.to(local.last_update.dtype)
    local.mail_valid.index_fill_(0, nid, False)
    local.mail_valid[wn, ws] = torch.ones_like(wn, dtype=torch.bool)
    local.mail_src[wn, ws] = mw_node.to(torch.int32)
    local.mail_dst[wn, ws] = mw_partner.to(torch.int32)
    local.mail_t[wn, ws] = mw_t.to(torch.float32)
    local.mail_eid[wn, ws] = mw_eid.to(torch.int32)
    trash = shard.n - 1 - shard.lo
    for t in local:
        t[shard.rows].zero_()
        if 0 <= trash < shard.rows:
            t[trash].zero_()
    return local
