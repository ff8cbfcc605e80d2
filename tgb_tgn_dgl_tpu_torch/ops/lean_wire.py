"""Lean wire: the neighbor cache and the clocks on the device
(device-cache mode; the port's counterpart of
tgb_tgn_dgl_tpu/ops/lean_wire.py).

The dedup wire (ops/wire.py) ships the cache rows the host packer read
from its own (N, K) cache and the Δt it resolved from its own clocks.  In
device-cache mode that state lives on the card (``StreamDeviceState``),
and the host ships only what follows from the batch's events
(data/lean_packer.py):

  host
    * per-block root sets and event→slot maps
    * the intra-batch COO as (row, event position, side): features, Δt
      and the column follow on the device
    * the mailbox write plan (ring slots from the host's mail pointers)
    * the resolved clock writes, sorted by (node, block): the reference's
      sequential ``time_assoc`` writes (model_utils.py:77-83) reduce to
      the last write per (node, block), a function of the batch alone
  device
    * cache rows gathered from the resident ``NeighborCacheState``
      (ops/neighbor_cache.py)
    * the clock of each node at each block by searchsorted over the
      write list
    * Δt grids, edge features and kinds: the same ``DevicePack`` the model
      reads from the host packer (``expand_lean``); the cache insert and
      the clock advance close the batch (``advance_stream``)

Clock semantics (reference model_utils.py:68-83):
  * train: clock(n, blk) is the time of n's last write in blocks ≤ blk
    (within a block neg < dst < src, the last event winning), else the
    pre-batch clock;
  * eval (2-D negatives): each block first wipes every clock to the
    block's max time (:78-79), then writes dst and src, so clock(n, blk)
    is the time of n's last src/dst write in block blk itself, else
    wipe_t[blk].

Everything here is plain torch with static shapes and no host
synchronisation.  Torch refuses an out-of-range scatter index where JAX
drops it: the intra COO's padding entries (row R, their columns running
past P) go to the grids' trash row R at column 0, and the cache merge
writes its dropped rows into a trash row below the table.  Gathers past
the end are clipped explicitly, as the JAX source clips them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..data.packer import (KIND_CACHE, KIND_INTRA, KIND_INVALID, KIND_SELF,
                           DevicePack)
from .neighbor_cache import (NeighborCacheState, init_neighbor_cache,
                             merge_events, reset_neighbor_cache)

Array = "np.ndarray | torch.Tensor"


class LeanWire(NamedTuple):
    """Host→device payload; every leading dim is a sticky shape bucket."""

    ev_src: Array         # (B,) int32
    ev_dst: Array         # (B,) int32
    ev_t: Array           # (B,) float32
    ev_idx: Array         # (B,) int32 global msg-table row
    ev_valid: Array       # (B,) bool
    ev_neg: Array         # (B,) or (B, M) int32
    ev_src_slot: Array    # (B,) int32
    ev_pos_slot: Array    # (B,) int32
    ev_neg_slot: Array    # (B,) or (B, M) int32
    root_nid: Array       # (R,) int32; padding rows = N
    root_blk: Array       # (R,) int32 dependency block of the slot
    # intra-batch in-edges, sorted by (row, col); padding row = R
    ia_row: Array         # (Ei,) int32
    ia_pos: Array         # (Ei,) int32 event position in [0, B)
    ia_side: Array        # (Ei,) int32, 1 = the partner is ev_src[pos]
    # mailbox write plan (as the WirePack's)
    mw_node: Array        # (2B,) int32, invalid = N
    mw_slot: Array        # (2B,) int32
    mw_partner: Array     # (2B,) int32
    mw_t: Array           # (2B,) float32
    mw_eid: Array         # (2B,) int32
    # resolved clock writes, sorted by (node, block); padding node = N
    upd_node: Array       # (Q,) int32
    upd_blk: Array        # (Q,) int32
    upd_t: Array          # (Q,) float32
    upd_last: Array       # (Q,) bool, the last entry of its node's run
    wipe_t: Array         # (Kb,) float32 eval: each block's wipe value
    wipe_final: Array     # () float32 eval: the last block's wipe value


class StreamDeviceState(NamedTuple):
    """The stream state on the device: the recency cache and the per-node
    clocks, (N + 1) rows each (row N takes the padded events)."""

    cache: NeighborCacheState   # (N + 1, K) each
    clock: torch.Tensor         # (N + 1,) float32


def init_stream_device_state(num_nodes: int, k: int,
                             device=None) -> StreamDeviceState:
    return StreamDeviceState(
        cache=init_neighbor_cache(num_nodes + 1, k, device),
        clock=torch.zeros(num_nodes + 1, dtype=torch.float32,
                          device=device))


def reset_stream_cache(st: StreamDeviceState) -> StreamDeviceState:
    """Train-epoch start: the cache is wiped and the clocks persist
    (reference epoch_utils.py:175; time_assoc never resets)."""
    return StreamDeviceState(cache=reset_neighbor_cache(st.cache),
                             clock=st.clock)


def clone_stream_state(st: StreamDeviceState) -> StreamDeviceState:
    """A copy of the state, tensor by tensor."""
    return StreamDeviceState(
        cache=NeighborCacheState(*(t.clone() for t in st.cache)),
        clock=st.clock.clone())


def _ss(sorted_seq: torch.Tensor, values: torch.Tensor,
        side: str) -> torch.Tensor:
    """``jnp.searchsorted`` (int64 positions)."""
    return torch.searchsorted(sorted_seq.contiguous(), values.contiguous(),
                              right=side == "right")


def _clock_at(wire: LeanWire, clock_table: torch.Tensor,
              q_node: torch.Tensor, q_blk: torch.Tensor, *,
              eval_mode: bool, batch_size: int) -> torch.Tensor:
    """The clock of each queried (node, block) (see the module docstring).
    The writes are sorted by (node, block), so first-position(node) ·
    (B + 1) + block increases strictly along the list (a block index is
    below B: every block holds an event), and one searchsorted over that
    key finds each query's last write at or before its block."""
    upd_node = wire.upd_node.to(torch.int64)
    upd_blk = wire.upd_blk.to(torch.int64)
    qn = q_node.reshape(-1).to(torch.int64)
    qb = q_blk.reshape(-1).to(torch.int64)
    mult = batch_size + 1
    entry_key = _ss(upd_node, upd_node, "left") * mult + upd_blk
    q_key = _ss(upd_node, qn, "left") * mult + qb
    hi = _ss(entry_key, q_key, "right") - 1
    his = hi.clamp_min(0)
    match = (hi >= 0) & (upd_node[his] == qn)
    if eval_mode:
        # the block's wipe erases earlier writes: only its own count
        match = match & (upd_blk[his] == qb)
        base = wire.wipe_t[qb.clamp(0, wire.wipe_t.shape[0] - 1)]
    else:
        base = clock_table[qn]
    return torch.where(match, wire.upd_t[his], base).reshape(q_node.shape)


def expand_lean(wire: LeanWire, state: StreamDeviceState,
                num_neighbors: int, intra_width: int, num_nodes: int, *,
                eval_mode: bool, batch_size: int
                ) -> Tuple[DevicePack, torch.Tensor]:
    """The full DevicePack from a lean wire and the resident stream
    state.  Returns (pack, nid_list), where nid_list (R·(K+1),) = [root
    nids ⊕ cache-cell nids] is the memory read set (``pack.uniq_nid``)
    in place of the host's unique table: a node may stand in it more than
    once, and apply_mail computes the same row for each copy, so the
    commit's duplicate writes carry equal values."""
    K, P, N = num_neighbors, intra_width, num_nodes
    R = wire.root_nid.shape[0]
    Bw = wire.ev_src.shape[0]
    dev = wire.root_nid.device
    root_nid_raw = wire.root_nid.to(torch.int64)
    root_valid = wire.root_nid != N
    root_nid = torch.where(root_valid, wire.root_nid, 0)
    rblk = torch.where(root_valid, wire.root_blk, 0)

    # ---- cache rows from the device-resident state ---------------------
    c_nbr = state.cache.neighbors[root_nid_raw]               # (R, K)
    c_eid = state.cache.e_id[root_nid_raw]
    c_t = state.cache.t[root_nid_raw]
    c_valid = (c_eid >= 0) & root_valid[:, None]
    c_nbr = torch.where(c_valid, c_nbr, 0)

    # ---- intra-batch COO -------------------------------------------------
    Ei = wire.ia_row.shape[0]
    ia_real = wire.ia_row < R
    pos = wire.ia_pos.clamp(0, Bw - 1).to(torch.int64)
    side1 = wire.ia_side == 1
    partner = torch.where(side1, wire.ev_src[pos], wire.ev_dst[pos])
    partner_slot = torch.where(side1, wire.ev_src_slot[pos],
                               wire.ev_pos_slot[pos])
    ia_blk = torch.where(
        ia_real, wire.root_blk[wire.ia_row.clamp_max(R - 1).to(torch.int64)],
        0)

    # ---- one clock query for the three edge kinds ----------------------
    q_node = torch.cat([c_nbr.reshape(-1), root_nid, partner])
    q_blk = torch.cat([rblk.repeat_interleave(K), rblk, ia_blk])
    clk = _clock_at(wire, state.clock, q_node, q_blk, eval_mode=eval_mode,
                    batch_size=batch_size)
    c_clock = clk[:R * K].reshape(R, K)
    self_clock = clk[R * K:R * K + R]
    p_clock = clk[R * K + R:]

    cache_dt = torch.where(c_valid, c_t - c_clock, 0.0)
    cache_kind = c_valid.to(torch.int8) * KIND_CACHE
    cache_feat = torch.where(c_valid, c_eid, 0)
    self_dt = torch.where(root_valid, 0.0 - self_clock, 0.0)
    self_kind = root_valid.to(torch.int8) * KIND_SELF
    ia_dt = torch.where(ia_real, wire.ev_t[pos] - p_clock, 0.0)
    ia_feat = torch.where(ia_real, wire.ev_idx[pos], 0)
    # column = rank within the row (entries sorted by (row, col)); the
    # padding entries (row R) go to the trash row's column 0
    row_lo = _ss(wire.ia_row, wire.ia_row, "left")
    ia_col = torch.where(
        ia_real, torch.arange(Ei, dtype=torch.int64, device=dev) - row_lo, 0)
    row = torch.where(ia_real, wire.ia_row, R).to(torch.int64)

    def scatter(init_val, vals):
        g = torch.full((R + 1, max(P, 1)), init_val, dtype=vals.dtype,
                       device=dev)
        g[row, ia_col] = vals
        return g[:R]

    root_loc = torch.arange(R, dtype=torch.int32, device=dev)
    cache_loc = R + torch.arange(R * K, dtype=torch.int32,
                                 device=dev).reshape(R, K)
    zeros = torch.zeros((R, 1), dtype=torch.int32, device=dev)
    cols = [[c_nbr, root_nid[:, None]], [cache_dt, self_dt[:, None]],
            [cache_kind, self_kind[:, None]], [cache_feat, zeros],
            [cache_loc, root_loc[:, None]]]
    if P > 0:
        # an intra edge's memory row is its partner's own root slot (same
        # node, same row)
        intra = (scatter(0, partner), scatter(0.0, ia_dt),
                 scatter(KIND_INVALID,
                         torch.full((Ei,), KIND_INTRA, dtype=torch.int8,
                                    device=dev)),
                 scatter(0, ia_feat), scatter(R, partner_slot))
        for c, x in zip(cols, intra):
            c.append(x)
    nbr_nid, nbr_dt, nbr_kind, nbr_feat, nbr_loc = (torch.cat(c, dim=1)
                                                    for c in cols)
    nid_list = torch.cat([torch.where(root_valid, root_nid, N),
                          torch.where(c_valid, c_nbr, N).reshape(-1)])
    pack = DevicePack(
        ev_src=wire.ev_src, ev_dst=wire.ev_dst, ev_t=wire.ev_t,
        ev_idx=wire.ev_idx, ev_valid=wire.ev_valid, ev_neg=wire.ev_neg,
        root_nid=root_nid, root_valid=root_valid,
        nbr_nid=torch.where(nbr_kind != KIND_INVALID, nbr_nid, 0),
        nbr_dt=nbr_dt, nbr_kind=nbr_kind, nbr_feat=nbr_feat,
        ev_src_slot=wire.ev_src_slot, ev_pos_slot=wire.ev_pos_slot,
        ev_neg_slot=wire.ev_neg_slot,
        uniq_nid=nid_list, root_loc=root_loc, nbr_loc=nbr_loc,
        mw_node=wire.mw_node, mw_slot=wire.mw_slot,
        mw_partner=wire.mw_partner, mw_t=wire.mw_t, mw_eid=wire.mw_eid,
    )
    return pack, nid_list


def advance_stream(state: StreamDeviceState, wire: LeanWire,
                   num_nodes: int, *, eval_mode: bool) -> StreamDeviceState:
    """Close the batch: insert its events into the device cache (the
    undirected last-K-by-e_id merge, reference neighbor_loader.py:52-104)
    and advance the clocks to their post-batch values.  Returns a new
    state."""
    N = num_nodes
    valid = wire.ev_valid
    # padded events go to the trash row with e_id -1
    cache = merge_events(state.cache, torch.where(valid, wire.ev_src, N),
                         torch.where(valid, wire.ev_dst, N), wire.ev_t,
                         torch.where(valid, wire.ev_idx, -1))
    if eval_mode:
        # every clock wiped to the last block's value: a 0-d device
        # tensor, expanded (never read on the host)
        clock = wire.wipe_final.to(state.clock.dtype).expand(N + 1).clone()
    else:
        clock = state.clock.clone()
    node = torch.where(wire.upd_last & (wire.upd_node != N), wire.upd_node,
                       N).to(torch.int64)
    # the non-last entries write 0.0 into row N, which is zeroed after
    clock[node] = torch.where(node != N, wire.upd_t, 0.0)
    clock[N:].zero_()
    return StreamDeviceState(cache=cache, clock=clock)
