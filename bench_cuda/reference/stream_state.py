"""Plain numpy reference of the stream state that TGN reads: dependency
blocks, the recent-K neighbour cache, the per-node clocks, the in-edge
grid of every root slot of a batch, the memory's read set and its mail
write plan.  It follows the semantics of the reference training code
(TGL/tgb-tgn-dgl: ``dependencyGraph.py``, ``neighbor_loader.py``,
``model_utils.py``, ``epoch_utils.py``) and imports nothing of the
program.

Semantics, per batch of B events with their negatives (train: one per
event; eval: the M fixed ones):

* blocks: an event's block is 1 + the largest block that already touched
  its source or its destination in this batch (negatives do not count);
* root slots: per block, the sorted unique nodes among its sources,
  destinations and negatives; slots are numbered block by block;
* clocks, updated block by block before the block's grid is read: in
  training the block's negatives, then destinations, then sources take
  their event's time (the last write wins); in eval every node takes the
  block's latest time, then destinations and sources take their own;
* the grid of a root slot (node r, block i) has K + 1 + P columns: the K
  cache entries of r as they stood before the batch (newest first, empty
  entries last), a self-loop (feature ones, Δt = 0 - clock(r)), then the
  last P of r's events in earlier blocks of the batch (oldest first).  A
  cache or intra column's Δt is the edge's time minus its source node's
  clock at block i;
* the cache insert after the batch keeps, per node, the K newest events
  (by event row, both directions of each event) among its old and new
  ones;
* the memory's read set is every root and every cached neighbour; the
  mail of a node is its last event of the batch (mailbox of one slot).

The column order and the root order are the ones the port's packer lays
out, so that a dropout draw over the grid the port hands its step lands
on the same edge on both sides (``bench_cuda/reference/tgn.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

KIND_INVALID, KIND_CACHE, KIND_INTRA, KIND_SELF = 0, 1, 2, 3


def level_batch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Dependency blocks of one batch, event by event."""
    last = {}
    out = np.empty(len(src), np.int64)
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        b = max(last.get(s, -1), last.get(d, -1)) + 1
        out[i] = b
        last[s] = b
        last[d] = b
    return out


class NegativeSampler:
    """Train negatives: uniform over the destination universe, colliding
    draws drawn again (the reference's ``NegLinkSamplerDest``), from a
    numpy PCG64 stream of ``seed``."""

    def __init__(self, dst_nodes: np.ndarray, seed: int):
        self.dst_nodes = np.asarray(dst_nodes)
        self.rng = np.random.default_rng(seed)

    def sample(self, pos_dst: np.ndarray) -> np.ndarray:
        n = len(pos_dst)
        out = self.dst_nodes[self.rng.integers(0, len(self.dst_nodes), n)]
        for _ in range(64):
            bad = out == pos_dst
            nb = int(bad.sum())
            if nb == 0:
                break
            out[bad] = self.dst_nodes[
                self.rng.integers(0, len(self.dst_nodes), nb)]
        return out.astype(np.int64)


class Grid(NamedTuple):
    """One packed batch, unpadded: T root slots with Kp columns each."""

    root_node: np.ndarray    # (T,)
    root_blk: np.ndarray     # (T,)
    nbr: np.ndarray          # (T, Kp) source node of each in-edge
    feat: np.ndarray         # (T, Kp) event row of its features
    dt: np.ndarray           # (T, Kp) float32
    kind: np.ndarray         # (T, Kp) int8
    ev_src_slot: np.ndarray  # (B,)
    ev_pos_slot: np.ndarray  # (B,)
    ev_neg_slot: np.ndarray  # (B, M)
    read_set: np.ndarray     # (U,) sorted nodes whose memory is read
    root_loc: np.ndarray     # (T,) row of each root in read_set
    nbr_loc: np.ndarray      # (T, Kp) row of each source, -1 when invalid
    mail_node: np.ndarray    # (W,) nodes that get a mail
    mail_partner: np.ndarray
    mail_t: np.ndarray
    mail_eid: np.ndarray


def batch_roots(blk: np.ndarray, src, dst, neg2d, num_nodes: int):
    """(root keys sorted, inverse) of a batch: key = block * N + node."""
    M = neg2d.shape[1]
    keys = np.concatenate([blk * num_nodes + src, blk * num_nodes + dst,
                           (np.repeat(blk, M) * num_nodes
                            + neg2d.ravel())])
    return np.unique(keys, return_inverse=True)


class _Clocks:
    """The clock of any node at any block of one batch, and the clock
    after the batch, as an (N, blocks) table."""

    def __init__(self, before: np.ndarray, src, dst, t, blk, neg2d,
                 eval_mode: bool):
        B, M = neg2d.shape
        N = len(before)
        self.before = before
        self.eval_mode = eval_mode
        self.nb = nb = int(blk.max()) + 1 if B else 0
        if eval_mode:
            # per block: every node at the block's latest time, then its
            # endpoints at their own (sources after destinations)
            self.tmax = np.full(nb, -np.inf, np.float32)
            np.maximum.at(self.tmax, blk, t)
            node = np.concatenate([dst, src])
            b2 = np.concatenate([blk, blk])
            val = np.concatenate([t, t])
        else:
            # negatives, then destinations, then sources, each in event
            # order: the last write to a (node, block) wins
            node = np.concatenate([neg2d.ravel(), dst, src])
            b2 = np.concatenate([np.repeat(blk, M), blk, blk])
            val = np.concatenate([np.repeat(t, M), t, t])
        key = node.astype(np.int64) * max(nb, 1) + b2
        last = len(key) - 1 - np.unique(key[::-1], return_index=True)[1]
        table = np.full((N, max(nb, 1)), np.nan, np.float32)
        table[node[last], b2[last]] = val[last]
        if not eval_mode:
            # a node keeps its last write of an earlier block
            has = ~np.isnan(table)
            idx = np.where(has, np.arange(table.shape[1])[None, :], -1)
            np.maximum.accumulate(idx, axis=1, out=idx)
            rows = np.arange(N)[:, None]
            table = np.where(idx >= 0, table[rows, np.maximum(idx, 0)],
                             before[:, None]).astype(np.float32)
        self.table = table

    def at(self, nodes: np.ndarray, blocks: np.ndarray) -> np.ndarray:
        """Clock of ``nodes`` right after block ``blocks`` updated it."""
        nodes = np.asarray(nodes, np.int64)
        blocks = np.broadcast_to(np.asarray(blocks, np.int64), nodes.shape)
        v = self.table[nodes, blocks]
        if self.eval_mode:
            # only this block's own write counts: the wipe erased the rest
            v = np.where(np.isnan(v), self.tmax[blocks], v)
        return v.astype(np.float32)

    def after(self) -> np.ndarray:
        """The clock of every node after the batch's last block."""
        if self.nb == 0:
            return self.before.copy()
        n = len(self.before)
        return self.at(np.arange(n), np.full(n, self.nb - 1))


class StreamState:
    """The recent-K cache (event row, neighbour, time; -1 rows empty) and
    the clocks, on the host."""

    def __init__(self, num_nodes: int, K: int):
        self.N, self.K = num_nodes, K
        self.nbr = np.zeros((num_nodes, K), np.int64)
        self.eid = np.full((num_nodes, K), -1, np.int64)
        self.t = np.full((num_nodes, K), -1.0, np.float32)
        self.clock = np.zeros(num_nodes, np.float32)

    def copy(self) -> "StreamState":
        out = StreamState(self.N, self.K)
        for k in ("nbr", "eid", "t", "clock"):
            setattr(out, k, getattr(self, k).copy())
        return out

    def reset_cache(self) -> None:
        """A train epoch's start: the cache empties, the clocks stay."""
        self.eid.fill(-1)
        self.t.fill(-1.0)

    def insert(self, src, dst, t, eidx) -> None:
        """Both directions of each event; per node the K newest (by event
        row, ties by direction) of its old and new entries, newest
        first."""
        B, K = len(src), self.K
        if B == 0:
            return
        node = np.concatenate([dst, src]).astype(np.int64)
        nbr = np.concatenate([src, dst]).astype(np.int64)
        eid = np.concatenate([eidx, eidx]).astype(np.int64)
        tt = np.concatenate([t, t]).astype(np.float32)
        half = np.concatenate([np.zeros(B, np.int64), np.ones(B, np.int64)])
        # the last K new entries of each node by (row, direction)
        srt = np.lexsort((half, eid, node))
        node, nbr, eid, tt, half = (a[srt] for a in (node, nbr, eid, tt,
                                                     half))
        first = np.searchsorted(node, node, side="left")
        last = np.searchsorted(node, node, side="right")
        keep = (last - 1 - np.arange(len(node))) < K
        node, nbr, eid, tt, half = (a[keep] for a in (node, nbr, eid, tt,
                                                      half))
        touched = np.unique(node)
        # the old valid entries of the touched nodes are all older
        old_ok = self.eid[touched] >= 0
        on = np.repeat(touched, K).reshape(-1, K)[old_ok]
        cand_node = np.concatenate([node, on])
        cand_eid = np.concatenate([eid, self.eid[touched][old_ok]])
        cand_half = np.concatenate([half, np.zeros(len(on), np.int64)])
        cand_nbr = np.concatenate([nbr, self.nbr[touched][old_ok]])
        cand_t = np.concatenate([tt, self.t[touched][old_ok]])
        srt = np.lexsort((cand_half, -cand_eid, cand_node))
        cand_node, cand_eid, cand_nbr, cand_t = (
            a[srt] for a in (cand_node, cand_eid, cand_nbr, cand_t))
        first = np.searchsorted(cand_node, cand_node, side="left")
        col = np.arange(len(cand_node)) - first
        ok = col < K
        self.eid[touched] = -1
        self.t[touched] = -1.0
        rows, cols = cand_node[ok], col[ok]
        self.eid[rows, cols] = cand_eid[ok]
        self.nbr[rows, cols] = cand_nbr[ok]
        self.t[rows, cols] = cand_t[ok]

    def advance_train(self, src, dst, t, eidx, blk, neg) -> None:
        """A train batch's effect on the state, without its grid: each
        node's clock is its last write (block by block: negatives, then
        destinations, then sources)."""
        B = len(src)
        neg2d = np.asarray(neg, np.int64).reshape(B, -1)
        M = neg2d.shape[1]
        node = np.concatenate([neg2d.ravel(), dst, src])
        b2 = np.concatenate([np.repeat(blk, M), blk, blk])
        val = np.concatenate([np.repeat(t, M), t, t])
        seq = np.argsort(b2, kind="stable")      # phases keep their order
        node, val = node[seq], val[seq]
        last = len(node) - 1 - np.unique(node[::-1], return_index=True)[1]
        self.clock[node[last]] = val[last]
        self.insert(src, dst, t, eidx)

    def read_set(self, src, dst, neg) -> np.ndarray:
        """The memory's read set of a batch, from the cache before it:
        every node of its events and negatives and every cached
        neighbour of those."""
        roots = np.unique(np.concatenate([src, dst, np.ravel(neg)]))
        c_ok = self.eid[roots] >= 0
        return np.unique(np.concatenate([roots, self.nbr[roots][c_ok]]))

    def pack(self, src, dst, t, eidx, blk, neg, P: Optional[int],
             eval_mode: bool, with_mail: bool = True) -> Grid:
        """The grid of one batch, read from the state before it; advances
        the clocks and inserts the batch into the cache."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        t = np.asarray(t, np.float32)
        eidx = np.asarray(eidx, np.int64)
        blk = np.asarray(blk, np.int64)
        B, N, K = len(src), self.N, self.K
        neg2d = np.asarray(neg, np.int64).reshape(B, -1)
        M = neg2d.shape[1]
        ukeys, inv = batch_roots(blk, src, dst, neg2d, N)
        T = len(ukeys)
        root_blk, root_node = ukeys // N, ukeys % N
        clocks = _Clocks(self.clock, src, dst, t, blk, neg2d, eval_mode)

        # the intra-batch predecessors of every root slot
        app_node = np.concatenate([src, dst])
        app_part = np.concatenate([dst, src])
        app_pos = np.concatenate([np.arange(B), np.arange(B)])
        srt = np.lexsort((app_pos, app_node))
        app_node, app_part, app_pos = (a[srt] for a in (app_node, app_part,
                                                        app_pos))
        kb = clocks.nb + 1
        app_key = app_node * kb + blk[app_pos]
        start = np.searchsorted(app_node, root_node, side="left")
        cnt = np.searchsorted(app_key, root_node * kb + root_blk,
                              side="left") - start
        if P is None:
            P = int(cnt.max(initial=0))
        m = np.minimum(cnt, P)
        Kp = K + 1 + P

        nbr = np.zeros((T, Kp), np.int64)
        feat = np.zeros((T, Kp), np.int64)
        dt = np.zeros((T, Kp), np.float32)
        kind = np.zeros((T, Kp), np.int8)
        # cache columns, as the cache stood before the batch
        c_eid = self.eid[root_node]
        c_ok = c_eid >= 0
        c_nbr = self.nbr[root_node]
        nbr[:, :K] = c_nbr
        kind[:, :K] = np.where(c_ok, KIND_CACHE, KIND_INVALID)
        feat[:, :K] = np.where(c_ok, c_eid, 0)
        c_clock = clocks.at(c_nbr, root_blk[:, None])
        dt[:, :K] = np.where(c_ok, self.t[root_node] - c_clock, 0.0)
        # the self-loop
        nbr[:, K] = root_node
        kind[:, K] = KIND_SELF
        dt[:, K] = 0.0 - clocks.at(root_node, root_blk)
        # the intra columns: the last m predecessors, oldest first
        rs = np.repeat(np.arange(T), m)
        j = np.arange(len(rs)) - np.repeat(np.cumsum(m) - m, m)
        a = np.repeat(start + cnt - m, m) + j
        part, pos = app_part[a], app_pos[a]
        nbr[rs, K + 1 + j] = part
        kind[rs, K + 1 + j] = KIND_INTRA
        feat[rs, K + 1 + j] = eidx[pos]
        dt[rs, K + 1 + j] = t[pos] - clocks.at(part, root_blk[rs])

        # the memory's read set: roots and cached neighbours
        read_set = np.unique(np.concatenate([root_node, c_nbr[c_ok]]))
        loc = np.full(N, -1, np.int64)
        loc[read_set] = np.arange(len(read_set))
        root_loc = loc[root_node]
        nbr_loc = np.where(kind != KIND_INVALID, loc[nbr], -1)

        mail = (batch_mail(src, dst, t, eidx) if with_mail else
                tuple(np.zeros(0, np.int64) for _ in range(4)))

        self.clock = clocks.after()
        self.insert(src, dst, t, eidx)
        return Grid(root_node=root_node, root_blk=root_blk, nbr=nbr,
                    feat=feat, dt=dt, kind=kind,
                    ev_src_slot=inv[:B], ev_pos_slot=inv[B:2 * B],
                    ev_neg_slot=inv[2 * B:].reshape(B, M),
                    read_set=read_set, root_loc=root_loc, nbr_loc=nbr_loc,
                    mail_node=mail[0], mail_partner=mail[1],
                    mail_t=mail[2].astype(np.float32), mail_eid=mail[3])


def batch_mail(src, dst, t, eidx):
    """(node, partner, time, event row) of the mail a batch posts: each
    endpoint's last event of the batch (the destination side of an event
    comes after its source side)."""
    B = len(src)
    wn = np.empty(2 * B, np.int64)
    wp = np.empty(2 * B, np.int64)
    wn[0::2], wn[1::2] = src, dst
    wp[0::2], wp[1::2] = dst, src
    last = np.unique(wn[::-1], return_index=True)[1]
    w = 2 * B - 1 - last
    return wn[w], wp[w], np.asarray(t)[w // 2], np.asarray(eidx)[w // 2]


def split_batches(rows: np.ndarray, batch_size: int):
    """(lo, hi) of each batch of a split's rows, in stream order."""
    return [(lo, min(lo + batch_size, len(rows)))
            for lo in range(0, len(rows), batch_size)]


def split_blocks(src, dst, rows, batch_size):
    """Dependency blocks of every batch of a split, flat."""
    out = np.empty(len(rows), np.int64)
    for lo, hi in split_batches(rows, batch_size):
        r = rows[lo:hi]
        out[lo:hi] = level_batch(src[r], dst[r])
    return out
