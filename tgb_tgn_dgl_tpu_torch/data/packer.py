"""Host-side stream-state emulator and batch packer (the port's copy of
tgb_tgn_dgl_tpu/data/packer.py, numpy path only, plus the hand-over of a
Pack to torch tensors on the device: ``to_device``).

Under the 'recent' strategy the Engine packs with the C++ twin of this
packer (data/native_packer.py) and ships wires (ops/wire.py);
``StreamPacker`` and ``to_device`` stay as the plain version that the
tests and chip_smoke.py hold the native packer and the device expansion
against.  Under 'uniform' the Engine packs with ``StreamPacker`` itself,
as the JAX package does (its factory takes the native packer for 'recent'
only): ``set_tcsr`` attaches the full-history t-CSR (data/tcsr.py), each
block of a batch samples its roots' K in-edges from it with a seed drawn
from the packer's ``_rng``, and ``pack_wire`` compacts the pack into a
``WirePack`` (``ops/wire.py::pack_to_wire``).

The crucial structural observation behind this framework: in the reference,
the recency neighbor cache (neighbor_loader.py) and the per-node clock
(``time_assoc``, model_utils.py:22,77-83) are *pure functions of the event
stream* — no learned state flows into them.  Everything ragged and
data-dependent about a batch (1-hop recency neighborhoods, dependency-block
root sets, intra-batch graph growth, Δt resolution) can therefore be
resolved on the host into fixed-shape dense grids, and the device runs a
single fused dense pass per batch with no dynamic shapes, no graph
mutation, and no sequential sub-block loop (SURVEY.md §7.2).

One packed batch ("Pack") contains, for every root slot (= one node rooted
at one dependency block, reference model_utils.py:85-92):

  * its K recency-cache in-edges (the ``in_subgraph`` + query of
    neighbor_loader.py:26-50 / model_utils.py:99),
  * one self-loop (epoch_utils.py:246-250: feature=1, time=0),
  * up to P intra-batch in-edges from earlier blocks (the growing graph of
    model_utils.py:151-157),

with Δt = t_edge − clock(src) already resolved (TemporalEdgePreprocess,
model_utils.py:440-449), plus event→slot maps for gathering src/pos/neg
embeddings (model_utils.py:135-137).

The packer emulates the reference's stateful host/device objects exactly:
cache insert is last-K-by-e_id merge (neighbor_loader.py:52-104), clocks
follow the n→p→s per-block update order (model_utils.py:77-83) including
the eval-mode global wipe (model_utils.py:78-79), e_ids are global event
row indices (so ``feats[e_id]`` hits the dataset msg table,
epoch_utils.py:224), and epoch-boundary resets match epoch_utils.py:175.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import tcsr as tcsr_mod

KIND_INVALID = 0
KIND_CACHE = 1
KIND_INTRA = 2
KIND_SELF = 3


class DevicePack(NamedTuple):
    """The array-only view of a Pack that crosses the host→device boundary
    (meta ints stay on the host).  ``to_device`` fills it with tensors."""

    ev_src: "np.ndarray"
    ev_dst: "np.ndarray"
    ev_t: "np.ndarray"
    ev_idx: "np.ndarray"
    ev_valid: "np.ndarray"
    ev_neg: "np.ndarray"
    root_nid: "np.ndarray"
    root_valid: "np.ndarray"
    nbr_nid: "np.ndarray"
    nbr_dt: "np.ndarray"
    nbr_kind: "np.ndarray"
    nbr_feat: "np.ndarray"
    ev_src_slot: "np.ndarray"
    ev_pos_slot: "np.ndarray"
    ev_neg_slot: "np.ndarray"
    uniq_nid: "np.ndarray"
    root_loc: "np.ndarray"
    nbr_loc: "np.ndarray"
    mw_node: "np.ndarray"
    mw_slot: "np.ndarray"
    mw_partner: "np.ndarray"
    mw_t: "np.ndarray"
    mw_eid: "np.ndarray"
    # gnn.layer > 1 (PackerConfig.layers > 1): per in-edge, the root slot
    # of (source node, SAME dependency block), or -1.  Layer l > 1 reads
    # the source's layer-(l-1) embedding through it; -1 = the source has
    # no root slot in this block, so its features pass through unchanged
    # (the reference's zero-in-degree identity residual,
    # model_utils.py:567-577 + commented layer stack :669-686).  None at
    # one layer.
    nbr_rslot: "Optional[np.ndarray]" = None


class Pack(NamedTuple):
    """One batch, fully resolved to static-shape dense arrays."""

    # events (padded to fixed B)
    ev_src: np.ndarray        # (B,) int32
    ev_dst: np.ndarray        # (B,) int32
    ev_t: np.ndarray          # (B,) float32
    ev_idx: np.ndarray        # (B,) int32 global event row (msg-table index)
    ev_valid: np.ndarray      # (B,) bool
    ev_neg: np.ndarray        # (B,) or (B, M) int32
    # root slots (padded to bucketed R)
    root_nid: np.ndarray      # (R,) int32
    root_valid: np.ndarray    # (R,) bool
    # per-root in-edge grid (R, Kp): Kp = K cache + 1 self + P intra
    nbr_nid: np.ndarray       # (R, Kp) int32 — source node of the edge
    nbr_dt: np.ndarray        # (R, Kp) float32 — t_edge − clock(src)
    nbr_kind: np.ndarray      # (R, Kp) int8
    nbr_feat: np.ndarray      # (R, Kp) int32 — msg-table row (kind 1/2)
    # event → root-slot maps
    ev_src_slot: np.ndarray   # (B,) int32
    ev_pos_slot: np.ndarray   # (B,) int32
    ev_neg_slot: np.ndarray   # (B,) or (B, M) int32
    # memory support (models/memory.py): unique read set + local maps
    uniq_nid: np.ndarray      # (U,) int32 — every node whose memory is
                              # read this batch (roots ∪ cache nbrs);
                              # padded entries = num_nodes (trash row)
    root_loc: np.ndarray      # (R,) int32 index into uniq table
    nbr_loc: np.ndarray       # (R, Kp) int32 index into uniq table
    # mailbox write plan: one (node, slot) pair per kept event-direction
    # write, unique by construction; invalid entries have node=num_nodes
    mw_node: np.ndarray       # (2B,) int32
    mw_slot: np.ndarray       # (2B,) int32
    mw_partner: np.ndarray    # (2B,) int32
    mw_t: np.ndarray          # (2B,) float32
    mw_eid: np.ndarray        # (2B,) int32
    num_blocks: int
    num_real_events: int
    num_real_roots: int
    # (R, Kp) int32 same-block root slot per in-edge (see DevicePack);
    # None when PackerConfig.layers == 1
    nbr_rslot: Optional[np.ndarray] = None

    def device(self) -> DevicePack:
        return DevicePack(**{f: getattr(self, f)
                             for f in DevicePack._fields})

    @property
    def shape_bucket(self):
        """(B, R, Kp, M) — the jit-recompile signature of this pack."""
        m = self.ev_neg.shape[1] if self.ev_neg.ndim == 2 else 1
        return (self.ev_src.shape[0], self.root_nid.shape[0],
                self.nbr_nid.shape[1], m)


def _bucket_pow2(n: int, lo: int = 128) -> int:
    b = lo
    while b < n:
        b *= 2
    # Quarter-octave refinement: the smallest of {5/8, 6/8, 7/8, 1}·b that
    # fits n.  Pure pow2 buckets waste up to 2× wire bytes, and H2D bytes
    # are the throughput wall on tunneled hosts (SURVEY.md §5.8).
    # NOTE: monotonicity is NOT a property of this function — callers MUST
    # wrap results in _sticky_bucket before using them as jit-compile
    # shape signatures (ops/wire.pack_to_wire's raw Ei is re-padded by
    # pack_wire for exactly this reason).  With stickiness the compile
    # count stays bounded: ≤4 steps per octave, one-time per profile via
    # the persistent cache.
    if b > lo and b % 8 == 0:
        for q in (5, 6, 7):
            c = b // 8 * q
            if c >= n:
                return c
    return b


def _bucket_p(p: int) -> int:
    if p <= 0:
        return 0
    b = 1
    while b < p:
        b *= 2
    return b


@dataclass
class PackerConfig:
    num_neighbors: int = 10          # K (config sampling.neighbor[0])
    batch_size: int = 2000
    max_intra_block: Optional[int] = None   # P cap (None = exact)
    root_bucket_lo: int = 128
    strategy: str = "recent"         # 'recent' | 'uniform' (TGL sampler knob)
    mailbox_size: int = 1            # S (config memory.mailbox_size)
    seed: int = 0
    # gnn.layer; above 1 the pack carries nbr_rslot
    layers: int = 1


class StreamPacker:
    """Stateful host emulator of (neighbor cache, node clocks, e_id counter)
    + per-batch packer.  One instance per training run; the engine drives
    it through the epoch protocol (reset at train start, continuous through
    val/test — reference epoch_utils.py:175, pyg-mem-tgn.py:54-63)."""

    def __init__(self, num_nodes: int, cfg: PackerConfig):
        self.N = num_nodes
        self.cfg = cfg
        K = cfg.num_neighbors
        self.cache_nbr = np.zeros((num_nodes, K), dtype=np.int32)
        self.cache_eid = np.full((num_nodes, K), -1, dtype=np.int64)
        self.cache_t = np.full((num_nodes, K), -1.0, dtype=np.float32)
        self.clock = np.zeros(num_nodes, dtype=np.float32)
        self.cur_e_id = 0
        # mailbox ring pointers (host mirror of MemoryState slot layout)
        self.mail_ptr = np.zeros(num_nodes, dtype=np.int64)
        # the 'uniform' strategy's draws: one sub-seed a block of every
        # pack.  Stream state that ``snapshot`` leaves out, as the JAX
        # packer's does (a val snapshot does not rewind the draws); the
        # Engine's checkpoint holds it
        self._rng = np.random.default_rng(cfg.seed)
        # full-history t-CSR for the 'uniform' strategy (set_tcsr);
        # 'recent' uses the streaming cache above
        self._tcsr = None
        # sticky shape buckets: monotone per (M, eval_mode) profile so a
        # whole run converges to one grid shape per profile
        self._sticky: dict = {}

    def _sticky_bucket(self, key, name: str, value: int) -> int:
        cur = self._sticky.setdefault(key, {})
        cur[name] = max(cur.get(name, 0), value)
        return cur[name]

    def bucket_state(self) -> dict:
        """A copy of the sticky shape buckets, {(M, eval_mode): {name:
        size}} (as ``NativeStreamPacker.bucket_state``)."""
        return {k: dict(v) for k, v in self._sticky.items()}

    def load_bucket_state(self, buckets) -> None:
        self._sticky = {tuple(k): dict(v) for k, v in buckets.items()}

    def set_tcsr(self, tcsr) -> None:
        """Attach a data/tcsr.py TCSR for strategy='uniform' sampling
        (the TGL full-history sampler role, reference config/TGN.yml:5-9)."""
        self._tcsr = tcsr

    # ---------------------------------------------------------------- state
    def reset_cache(self) -> None:
        """Train-epoch-start reset (reference neighbor_loader.py:106-109 via
        epoch_utils.py:175).  Clocks intentionally persist — ``time_assoc``
        is never reset in the reference.  Mailbox ring pointers reset with
        the cache (PyG path resets memory + cache together at train start,
        reference pyg_epoch_utils.py:11-16; the engine resets the device
        MemoryState in the same place)."""
        self.cache_eid.fill(-1)
        self.cache_t.fill(-1.0)
        self.cur_e_id = 0
        self.mail_ptr.fill(0)

    def snapshot(self):
        """State backup for val→test protocol experiments (analogue of
        MemoryModule.backup_memory, reference model_utils.py:290-297)."""
        return (self.cache_nbr.copy(), self.cache_eid.copy(),
                self.cache_t.copy(), self.clock.copy(), self.cur_e_id,
                self.mail_ptr.copy())

    def restore(self, snap) -> None:
        self.cache_nbr, self.cache_eid, self.cache_t, self.clock, \
            self.cur_e_id, self.mail_ptr = (
                snap[0].copy(), snap[1].copy(), snap[2].copy(),
                snap[3].copy(), snap[4], snap[5].copy())

    # --- row-level state surgery (the owned exchange's scratch packs,
    # parallel/owned_state.py::pack_with_gathered_state); the plain
    # version of NativeStreamPacker's
    def rows_api_available(self) -> bool:
        return True

    def set_rows(self, nodes, nbr, eid, t, clock) -> None:
        nodes = np.asarray(nodes, np.int64)
        self.cache_nbr[nodes] = nbr
        self.cache_eid[nodes] = eid
        self.cache_t[nodes] = t
        self.clock[nodes] = clock

    def set_clock_rows(self, nodes, clock) -> None:
        self.clock[np.asarray(nodes, np.int64)] = clock

    def set_mail_rows(self, nodes, ptr) -> None:
        self.mail_ptr[np.asarray(nodes, np.int64)] = ptr

    def clear_rows(self, nodes, zero_all_clocks: bool = False) -> None:
        nodes = np.asarray(nodes, np.int64)
        self.cache_nbr[nodes] = 0
        self.cache_eid[nodes] = -1
        self.cache_t[nodes] = -1.0
        self.clock[nodes] = 0.0
        self.mail_ptr[nodes] = 0
        if zero_all_clocks:
            self.clock.fill(0.0)

    def insert(self, src: np.ndarray, dst: np.ndarray, t: np.ndarray,
               e_id: Optional[np.ndarray] = None) -> None:
        """Undirected recency insert, last-K by e_id per node — host mirror
        of ops/neighbor_cache.insert_events (reference
        neighbor_loader.py:52-104)."""
        B = len(src)
        if B == 0:
            return
        if e_id is None:
            e_id = self.cur_e_id + np.arange(B, dtype=np.int64)
        nodes = np.concatenate([dst, src]).astype(np.int64)
        nbrs = np.concatenate([src, dst]).astype(np.int32)
        eids = np.concatenate([e_id, e_id]).astype(np.int64)
        tt = np.concatenate([t, t]).astype(np.float32)
        half = np.concatenate([np.zeros(B, np.int8), np.ones(B, np.int8)])
        order = np.lexsort((half, eids, nodes))
        nodes, nbrs, eids, tt = nodes[order], nbrs[order], eids[order], tt[order]
        uniq, starts = np.unique(nodes, return_index=True)
        ends = np.append(starts[1:], len(nodes))
        K = self.cfg.num_neighbors
        for u, s, e in zip(uniq, starts, ends):
            lo = max(s, e - K)
            new_n = nbrs[lo:e]
            new_e = eids[lo:e]
            new_t = tt[lo:e]
            cat_e = np.concatenate([self.cache_eid[u], new_e])
            cat_n = np.concatenate([self.cache_nbr[u], new_n])
            cat_t = np.concatenate([self.cache_t[u], new_t])
            top = np.argsort(-cat_e, kind="stable")[:K]
            self.cache_eid[u] = cat_e[top]
            self.cache_nbr[u] = cat_n[top]
            self.cache_t[u] = cat_t[top]
        self.cur_e_id = int(max(self.cur_e_id, int(e_id.max()) + 1))

    # ----------------------------------------------------------------- pack
    def pack(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        t: np.ndarray,
        ev_idx: np.ndarray,
        blocks: np.ndarray,
        neg: np.ndarray,
        eval_mode: bool = False,
        insert: bool = True,
        write_mail: bool = True,
    ) -> Pack:
        """Pack one batch and (by default) advance the stream state.

        ``neg`` is (B,) for training (1 negative/event) or (B, M) for eval
        (fixed negative sets).  ``eval_mode`` selects the reference's
        2D-negative clock semantics (global wipe, model_utils.py:77-79).
        """
        cfg = self.cfg
        K = cfg.num_neighbors
        Braw = len(src)
        B = cfg.batch_size
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        t = np.asarray(t, np.float32)
        blocks = np.asarray(blocks, np.int64)
        neg = np.asarray(neg, np.int32)
        neg2d = neg.reshape(Braw, -1)
        M = neg2d.shape[1]
        k = int(blocks.max()) + 1 if Braw else 0

        # --- per-node intra-batch event lists (for growing-graph edges) ---
        # entry: (node, partner, event position); block asc == position asc
        # per node (dependency invariant).
        nodes2 = np.concatenate([src, dst]).astype(np.int64)
        part2 = np.concatenate([dst, src]).astype(np.int32)
        pos2 = np.concatenate([np.arange(Braw), np.arange(Braw)]).astype(np.int64)
        order2 = np.lexsort((pos2, nodes2))
        s_nodes2 = nodes2[order2]
        s_part2 = part2[order2]
        s_pos2 = pos2[order2]
        s_blk2 = blocks[s_pos2]
        run_nodes, run_starts = np.unique(s_nodes2, return_index=True)
        run_ends = np.append(run_starts[1:], len(s_nodes2))
        run_of = {int(u): (int(a), int(b))
                  for u, a, b in zip(run_nodes, run_starts, run_ends)}

        # --- pass 1: root sets + slot maps -------------------------------
        root_nid_parts: List[np.ndarray] = []
        block_sel: List[np.ndarray] = []
        offsets = [0]
        ev_src_slot = np.zeros(Braw, np.int64)
        ev_pos_slot = np.zeros(Braw, np.int64)
        ev_neg_slot = np.zeros((Braw, M), np.int64)
        for i in range(k):
            sel = np.nonzero(blocks == i)[0]
            block_sel.append(sel)
            # unique(s ∪ p ∪ n) — sorted, as reference model_utils.py:85-86
            roots_i = np.unique(np.concatenate(
                [src[sel], dst[sel], neg2d[sel].ravel()]))
            off = offsets[-1]
            ev_src_slot[sel] = np.searchsorted(roots_i, src[sel]) + off
            ev_pos_slot[sel] = np.searchsorted(roots_i, dst[sel]) + off
            ev_neg_slot[sel] = np.searchsorted(roots_i, neg2d[sel]) + off
            root_nid_parts.append(roots_i.astype(np.int32))
            offsets.append(off + len(roots_i))
        total_roots = offsets[-1]
        root_nid_all = (np.concatenate(root_nid_parts)
                        if root_nid_parts else np.zeros(0, np.int32))

        # P = max intra-batch predecessors over root slots (exact), capped.
        intra_counts = np.zeros(total_roots, np.int32)
        for i in range(k):
            off = offsets[i]
            for j, r in enumerate(root_nid_parts[i]):
                run = run_of.get(int(r))
                if run is None:
                    continue
                a, b2 = run
                cnt = int(np.searchsorted(s_blk2[a:b2], i, side="left"))
                intra_counts[off + j] = cnt
        P_exact = int(intra_counts.max()) if total_roots else 0
        skey = (M, bool(eval_mode))
        if cfg.max_intra_block is not None:
            # fixed grid width: every batch compiles to the same bucket
            # (per-batch pow2 widths caused one XLA compile per width)
            P_exact = min(P_exact, cfg.max_intra_block)
            P = cfg.max_intra_block
        else:
            P = self._sticky_bucket(skey, "P", _bucket_p(P_exact))
        Kp = K + 1 + P
        R = self._sticky_bucket(
            skey, "R", _bucket_pow2(max(total_roots, 1), cfg.root_bucket_lo))

        nbr_nid = np.zeros((R, Kp), np.int32)
        nbr_dt = np.zeros((R, Kp), np.float32)
        nbr_kind = np.zeros((R, Kp), np.int8)
        nbr_feat = np.zeros((R, Kp), np.int32)
        root_nid = np.zeros(R, np.int32)
        root_valid = np.zeros(R, bool)
        root_nid[:total_roots] = root_nid_all
        root_valid[:total_roots] = True

        # --- pass 2: per-block clock updates + grid fill ------------------
        for i in range(k):
            sel = block_sel[i]
            ti = t[sel]
            # clock updates in reference order n → p → s
            # (model_utils.py:77-83); vectorized assignment = last-write-wins
            # like torch.
            if eval_mode:
                self.clock[:] = ti.max() if len(ti) else self.clock
            else:
                self.clock[neg2d[sel].ravel()] = np.repeat(ti, M)
            self.clock[dst[sel]] = ti
            self.clock[src[sel]] = ti

            off = offsets[i]
            roots_i = root_nid_parts[i]
            n_i = len(roots_i)
            rows = slice(off, off + n_i)
            if cfg.strategy == "uniform" and self._tcsr is not None:
                # TGL 'uniform' strategy: K uniform neighbors from each
                # root's full history before its current clock
                sub_seed = int(self._rng.integers(0, 2 ** 62))
                c_nbr, c_eid, c_t = tcsr_mod.sample(
                    self._tcsr, roots_i, self.clock[roots_i], K,
                    strategy="uniform", seed=sub_seed)
                c_eid = c_eid.astype(np.int64)
            else:
                # 'recent': streaming recency-cache in-edges (snapshot is
                # pre-batch: inserts happen after)
                c_nbr = self.cache_nbr[roots_i]             # (n_i, K)
                c_eid = self.cache_eid[roots_i]
                c_t = self.cache_t[roots_i]
            valid = c_eid >= 0
            nbr_nid[rows, :K] = c_nbr
            nbr_kind[rows, :K] = np.where(valid, KIND_CACHE, KIND_INVALID)
            nbr_feat[rows, :K] = np.where(valid, c_eid, 0).astype(np.int32)
            nbr_dt[rows, :K] = np.where(
                valid, c_t - self.clock[c_nbr], 0.0)
            # self-loop: feature=ones, time=0 (epoch_utils.py:246-250)
            nbr_nid[rows, K] = roots_i
            nbr_kind[rows, K] = KIND_SELF
            nbr_dt[rows, K] = 0.0 - self.clock[roots_i]
            # intra-batch in-edges from earlier blocks
            if P > 0:
                for j, r in enumerate(roots_i):
                    full = int(intra_counts[off + j])
                    if full == 0:
                        continue
                    a, _ = run_of[int(r)]
                    # keep the most recent P predecessors when capped
                    lo = a + max(0, full - P)
                    take = s_pos2[lo:a + full]
                    m = len(take)
                    partners = s_part2[lo:a + full]
                    col = slice(K + 1, K + 1 + m)
                    nbr_nid[off + j, col] = partners
                    nbr_kind[off + j, col] = KIND_INTRA
                    nbr_feat[off + j, col] = ev_idx[take]
                    nbr_dt[off + j, col] = t[take] - self.clock[partners]

        # --- multi-layer: same-block root-slot index per in-edge ----------
        # Layer l > 1 reads a source's layer-(l-1) embedding iff the source
        # has a root slot in the SAME dependency block (the reference's
        # commented layer stack runs every conv over one in_subgraph whose
        # vertices are that sub-block's roots, model_utils.py:99,669-686;
        # a non-root source has zero in-degree there and passes its input
        # through the identity residual, :567-577,541-546).
        nbr_rslot = None
        if cfg.layers > 1:
            nbr_rslot = np.full((R, Kp), -1, np.int32)
            for i in range(k):
                off = offsets[i]
                roots_i = root_nid_parts[i]            # sorted unique
                n_i = len(roots_i)
                if n_i == 0:
                    continue
                rows = slice(off, off + n_i)
                sub_nid = nbr_nid[rows]
                idx = np.minimum(np.searchsorted(roots_i, sub_nid), n_i - 1)
                found = ((roots_i[idx] == sub_nid)
                         & (nbr_kind[rows] != KIND_INVALID))
                nbr_rslot[rows] = np.where(found, off + idx, -1)

        # --- memory read set + local index maps ---------------------------
        # uniq = every node whose memory rows the model reads: roots
        # (event endpoints + negatives) ∪ cache neighbors.  Intra-batch
        # partners and self-loops are endpoints, hence already roots.
        cache_mask = nbr_kind == KIND_CACHE
        uniq = np.unique(np.concatenate(
            [root_nid_all, nbr_nid[cache_mask].ravel()])) \
            if total_roots else np.zeros(0, np.int64)
        U = len(uniq)
        Ub = self._sticky_bucket(
            skey, "Ub", _bucket_pow2(U + 1, cfg.root_bucket_lo))
        uniq_nid = np.full(Ub, self.N, np.int32)       # pad = trash row
        uniq_nid[:U] = uniq
        root_loc = np.full(R, Ub - 1, np.int32)        # pad roots → trash
        root_loc[:total_roots] = np.searchsorted(uniq, root_nid_all)
        nbr_loc = np.full((R, Kp), Ub - 1, np.int32)
        nbr_ok = nbr_kind != KIND_INVALID
        nbr_loc[nbr_ok] = np.searchsorted(uniq, nbr_nid[nbr_ok])

        # --- mailbox write plan (ring slots, last-S per node) -------------
        S = cfg.mailbox_size
        W = 2 * B
        mw_node = np.full(W, self.N, np.int32)
        mw_slot = np.zeros(W, np.int32)
        mw_partner = np.zeros(W, np.int32)
        mw_t = np.zeros(W, np.float32)
        mw_eid = np.zeros(W, np.int32)
        if Braw and write_mail:
            wnode = np.empty(2 * Braw, np.int64)
            wpart = np.empty(2 * Braw, np.int64)
            wnode[0::2], wnode[1::2] = src, dst
            wpart[0::2], wpart[1::2] = dst, src
            wt = np.repeat(t, 2)
            weid = np.repeat(np.asarray(ev_idx, np.int64), 2)
            posw = np.arange(2 * Braw)
            order = np.lexsort((posw, wnode))
            sn = wnode[order]
            runs, starts = np.unique(sn, return_index=True)
            ends = np.append(starts[1:], len(sn))
            for u, a, b2 in zip(runs, starts, ends):
                c = b2 - a
                kept = min(c, S)
                take = order[b2 - kept:b2]      # last `kept`, in order
                ptr = self.mail_ptr[u]
                slots = (ptr + np.arange(kept)) % S
                if insert:  # ring pointers advance only when the batch
                    self.mail_ptr[u] = (ptr + kept) % S  # commits state
                out = take            # positions within the W buffer
                mw_node[out] = u
                mw_slot[out] = slots
                mw_partner[out] = wpart[take]
                mw_t[out] = wt[take]
                mw_eid[out] = weid[take]

        # --- pad events to fixed B ----------------------------------------
        def pad1(a, fill=0, dtype=None):
            out = np.full(B, fill, dtype=dtype or a.dtype)
            out[:Braw] = a
            return out

        ev_valid = np.zeros(B, bool)
        ev_valid[:Braw] = True
        ev_neg_out = np.zeros((B, M), np.int32)
        ev_neg_out[:Braw] = neg2d
        ev_neg_slot_out = np.zeros((B, M), np.int32)
        ev_neg_slot_out[:Braw] = ev_neg_slot
        pack = Pack(
            ev_src=pad1(src), ev_dst=pad1(dst), ev_t=pad1(t),
            ev_idx=pad1(np.asarray(ev_idx, np.int32)),
            ev_valid=ev_valid,
            ev_neg=ev_neg_out if M > 1 else ev_neg_out[:, 0],
            root_nid=root_nid, root_valid=root_valid,
            nbr_nid=nbr_nid, nbr_dt=nbr_dt, nbr_kind=nbr_kind,
            nbr_feat=nbr_feat,
            ev_src_slot=pad1(ev_src_slot.astype(np.int32)),
            ev_pos_slot=pad1(ev_pos_slot.astype(np.int32)),
            ev_neg_slot=(ev_neg_slot_out if M > 1 else ev_neg_slot_out[:, 0]),
            uniq_nid=uniq_nid, root_loc=root_loc, nbr_loc=nbr_loc,
            mw_node=mw_node, mw_slot=mw_slot, mw_partner=mw_partner,
            mw_t=mw_t, mw_eid=mw_eid,
            num_blocks=k,
            num_real_events=Braw,
            num_real_roots=total_roots,
            nbr_rslot=nbr_rslot,
        )

        if insert:
            self.insert(src, dst, t, e_id=np.asarray(ev_idx, np.int64))
        return pack

    def pack_wire(self, src, dst, t, ev_idx, blocks, neg,
                  eval_mode: bool = False, insert: bool = True,
                  write_mail: bool = True):
        """(WirePack, intra_width): the full pack, then ``pack_to_wire``
        (the native packer emits the wire directly).  The intra COO's
        length ``Ei`` is a sticky bucket too: a shorter list is padded
        with row R (the trash row), -1 rslots and zeros."""
        from ..ops.wire import pack_to_wire

        pack = self.pack(src, dst, t, ev_idx, blocks, neg,
                         eval_mode=eval_mode, insert=insert,
                         write_mail=write_mail)
        K = self.cfg.num_neighbors
        wire = pack_to_wire(pack, K)
        neg_arr = np.asarray(neg)
        M = neg_arr.shape[1] if neg_arr.ndim == 2 else 1
        n = wire.ia_row.shape[0]
        Ei = self._sticky_bucket((M, bool(eval_mode)), "Ei", n)
        if Ei != n:
            R = pack.root_nid.shape[0]

            def pad(a, fill):
                return np.concatenate([a, np.full(Ei - n, fill, a.dtype)])

            wire = wire._replace(
                ia_row=pad(wire.ia_row, R), ia_col=pad(wire.ia_col, 0),
                ia_loc=pad(wire.ia_loc, 0), ia_feat=pad(wire.ia_feat, 0),
                ia_dt=pad(wire.ia_dt, 0.0),
                ia_rslot=(None if wire.ia_rslot is None
                          else pad(wire.ia_rslot, -1)))
        return wire, pack.nbr_kind.shape[1] - K - 1


def to_device(pack: Pack, device) -> DevicePack:
    """Every ``Pack.device()`` field as a torch tensor on ``device``
    (``nbr_rslot`` stays None at one layer).  For a CUDA device the host
    arrays go through pinned memory and a ``non_blocking`` copy on the
    current stream; the caching host allocator keeps each pinned buffer
    alive until its copy has run."""
    device = torch.device(device)
    pinned = device.type == "cuda"

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pinned:
            t = t.pin_memory()
        return t.to(device, non_blocking=pinned)

    return DevicePack(*(None if a is None else put(a)
                        for a in pack.device()))
