"""Functional recency neighbor cache on the device (the port's counterpart
of tgb_tgn_dgl_tpu/ops/neighbor_cache.py).

A fixed-size (N, K) most-recent-neighbor buffer per node, as the
reference's ``LastNeighborLoader`` keeps it (neighbor_loader.py:15-109),
queried as a dense grid and updated by a merge that keeps the K largest
event ids per node.  The state is a NamedTuple of tensors; every function
returns new tensors and leaves its inputs as they were.

Every shape comes from host ints, and nothing here reads a device value
on the host: no ``.item()``, no boolean-mask indexing, no ``nonzero``.
The K largest event ids are taken by a stable sort of the negated ids,
so equal ids (the empty slots' -1) keep their column order, the lower
index first, as ``jax.lax.top_k`` orders ties; ``torch.topk`` promises no
order among ties.  The merge writes one row per node, at the node's last
entry in the sorted batch; the other entries write into a trash row below
the table, the rows JAX drops as out of range.

Device-cache mode (ops/lean_wire.py) keeps this state on the card, and
this module is also the device-resident ``LastNeighborLoader`` for online
serving.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class NeighborCacheState(NamedTuple):
    neighbors: torch.Tensor  # (N, K) int32 global neighbor node ids
    e_id: torch.Tensor       # (N, K) int32 event id, -1 = empty slot
    t: torch.Tensor          # (N, K) float32 event time, -1 = empty
    cur_e_id: torch.Tensor   # () int32 next event id


def init_neighbor_cache(num_nodes: int, size: int,
                        device=None) -> NeighborCacheState:
    """``reset_state`` semantics: e_id and t at -1 (reference
    neighbor_loader.py:106-109)."""
    shape = (num_nodes, size)
    return NeighborCacheState(
        neighbors=torch.zeros(shape, dtype=torch.int32, device=device),
        e_id=torch.full(shape, -1, dtype=torch.int32, device=device),
        t=torch.full(shape, -1.0, dtype=torch.float32, device=device),
        cur_e_id=torch.zeros((), dtype=torch.int32, device=device),
    )


def reset_neighbor_cache(state: NeighborCacheState) -> NeighborCacheState:
    """Every slot empty and the event counter at 0; the stale neighbor ids
    stay, as in the JAX package."""
    return NeighborCacheState(
        neighbors=state.neighbors,
        e_id=torch.full_like(state.e_id, -1),
        t=torch.full_like(state.t, -1.0),
        cur_e_id=torch.zeros_like(state.cur_e_id),
    )


def query_neighbors(state: NeighborCacheState, n_id: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Dense 1-hop query: (M,) node ids -> (neighbors, e_id, t, mask),
    each (M, K); the mask replaces the reference's e_id >= 0 filter
    (neighbor_loader.py:41-42)."""
    idx = n_id.long()
    eid = state.e_id[idx]
    return state.neighbors[idx], eid, state.t[idx], eid >= 0


def merge_events(state: NeighborCacheState, src: torch.Tensor,
                 dst: torch.Tensor, t: torch.Tensor,
                 e_id: torch.Tensor) -> NeighborCacheState:
    """Insert a batch of B events with explicit event ids into the
    undirected cache; an event with e_id -1 loses every tie and is never
    kept.  Each event (u, v) contributes v to u's row and u to v's
    (reference order: neighbors = [src, dst], nodes = [dst, src],
    neighbor_loader.py:57-58); per node the union of its cached and new
    entries is cut to the K largest e_ids (:91-104), and more than K new
    entries of one node resolve deterministically: ordered by (node,
    event, direction), the last K win.  ``cur_e_id`` is kept."""
    N, K = state.neighbors.shape
    B = src.shape[0]
    M = 2 * B
    dev = src.device
    nodes = torch.cat([dst, src]).to(torch.int64)
    nbrs = torch.cat([src, dst]).to(torch.int32)
    eid = torch.cat([e_id, e_id]).to(torch.int32)
    tt = torch.cat([t, t]).to(torch.float32)
    ar = torch.arange(B, dtype=torch.int64, device=dev)
    # sort by (node, event, direction): a stable sort by the event-major
    # subkey, then a stable sort by node (two passes, no composite key)
    subkey = torch.cat([2 * ar, 2 * ar + 1])
    perm1 = torch.argsort(subkey, stable=True)
    perm2 = torch.argsort(nodes[perm1], stable=True)
    order = perm1[perm2]
    s_nodes, s_nbrs, s_eid, s_t = (a[order] for a in (nodes, nbrs, eid, tt))

    idx = torch.arange(M, dtype=torch.int64, device=dev)
    differ = s_nodes[1:] != s_nodes[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_start = torch.cat([one, differ])
    is_end = torch.cat([differ, one])
    # each position's run start, by a running max
    run_start = torch.cummax(torch.where(is_start, idx, -1), dim=0).values

    # at each run end, that node's last K new entries
    j = torch.arange(K, dtype=torch.int64, device=dev)
    gpos = idx[:, None] - (K - 1 - j)[None, :]                  # (M, K)
    new_valid = (gpos >= run_start[:, None]) & is_end[:, None]
    gsafe = gpos.clamp(0, M - 1)
    g_eid = s_eid[gsafe]
    new_nbrs = s_nbrs[gsafe]
    new_eid = torch.where(new_valid & (g_eid >= 0), g_eid, -1)
    new_t = torch.where(new_eid >= 0, s_t[gsafe], -1.0)

    # merge with the cached rows and keep the K largest e_ids, ties in
    # column order (jax.lax.top_k's rule)
    cat_nbrs = torch.cat([state.neighbors[s_nodes], new_nbrs], dim=1)
    cat_eid = torch.cat([state.e_id[s_nodes], new_eid], dim=1)  # (M, 2K)
    cat_t = torch.cat([state.t[s_nodes], new_t], dim=1)
    perm = torch.argsort(-cat_eid.to(torch.int64), dim=1,
                         stable=True)[:, :K]

    # write the run ends; every other entry goes to a trash row below
    # the table
    write_idx = torch.where(is_end, s_nodes, N)

    def write(table, rows):
        out = torch.cat([table, table[:1]])
        out[write_idx] = rows
        return out[:N]

    return NeighborCacheState(
        neighbors=write(state.neighbors, torch.gather(cat_nbrs, 1, perm)),
        e_id=write(state.e_id, torch.gather(cat_eid, 1, perm)),
        t=write(state.t, torch.gather(cat_t, 1, perm)),
        cur_e_id=state.cur_e_id,
    )


def insert_events(state: NeighborCacheState, src: torch.Tensor,
                  dst: torch.Tensor, t: torch.Tensor) -> NeighborCacheState:
    """Insert a batch of events numbered from ``cur_e_id`` on: the
    vectorized re-expression of reference neighbor_loader.py:52-104 (O(B·K)
    work, static shapes); the counter advances by B."""
    B = src.shape[0]
    e_id = state.cur_e_id + torch.arange(B, dtype=torch.int32,
                                         device=src.device)
    out = merge_events(state, src, dst, t, e_id)
    return out._replace(cur_e_id=state.cur_e_id + B)
