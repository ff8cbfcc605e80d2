"""Host→device wire formats for packed batches (the port's counterpart of
tgb_tgn_dgl_tpu/ops/wire.py).

The full (R, Kp) in-edge grids of a Pack run to ~30 MB per M=999 eval
chunk; a wire ships only what the device cannot rebuild, and the device
rebuilds the full ``DevicePack`` with gathers, so the model code is
unchanged.  Three formats, as in the JAX package:

  * ``WirePack``: the cache part as (R, K) loc/feat/dt (feat = -1 marks an
    empty slot), the self-loop column as one (R,) dt vector, the intra
    part as a COO list, slot maps, uniq table and mailbox plan.
  * ``CompactWire``: a WirePack with uint16/uint8 index fields, the
    intra feature as a batch position, and the mailbox plan as one slot
    per event direction.  The Engine ships it for a batch that the dedup
    wire cannot carry (an intra window over 255), and for every batch at
    gnn.layer > 1, where it and the WirePack carry the same-block root
    slots of the in-edges (``cache_rslot``, ``ia_rslot``).
  * ``DedupWire``, the Engine's wire: cache rows
    once per unique root node, the intra COO as per-slot windows into one
    node-major entry table, and at eval (``eval_lean_dedup``) no Δt at all:
    the device derives them from its event-time table and per-block
    metadata.  With ``train.wire_train_lean`` a train wire drops its Δt
    too (``train_lean_dedup``): it carries the pre-batch clock rows of its
    unique table, and the device replays the batch's clock writes.

Host side (numpy): ``stack_wires``, ``pack_to_wire`` (a full Pack to a
WirePack: the 'uniform' strategy's numpy pack), ``compact_wire``,
``nb_bucket_of``,
``_lean_block_meta``, ``eval_lean_dedup``, ``train_lean_dedup``.  Device
side (torch): ``wire_to_device`` (one staging buffer, one pinned
non-blocking copy for a wire and the arrays that travel with it; uint16
fields widen to int32 right after the copy), ``uncompact_wire``,
``_mw_from_slots``, ``expand_dedup``, ``expand_wire``, ``expand_any``.
Every shape of the
expansion comes from host ints (the wire's array shapes and the intra
width), so it never waits for the device.  Every expansion is bit-equal
to ``data/packer.py::to_device`` of the numpy pack
(tests/test_torch_wire.py).

Not ported yet: the blob wire of the fused steps (``BlobWire``,
``blob_stack``, ``unblob_one``).  Device-cache mode's lean wire is in
ops/lean_wire.py.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..data.packer import (KIND_CACHE, KIND_INTRA, KIND_SELF, DevicePack,
                           Pack, _bucket_pow2)

Array = "np.ndarray | torch.Tensor"
# a CompactWire's rslot fields ship as u16 while every slot (R - 1) is at
# most RSLOT_U16_MAX, with RSLOT_NONE_U16 for -1 ("no same-block root")
RSLOT_U16_MAX = 0xFFFE
RSLOT_NONE_U16 = 0xFFFF


class WirePack(NamedTuple):
    ev_src: Array
    ev_dst: Array
    ev_t: Array
    ev_idx: Array
    ev_valid: Array
    ev_neg: Array
    ev_src_slot: Array
    ev_pos_slot: Array
    ev_neg_slot: Array
    uniq_nid: Array       # (Ub,)
    root_loc: Array       # (R,)
    cache_loc: Array      # (R, K)
    cache_feat: Array     # (R, K), -1 = empty slot
    cache_dt: Array       # (R, K)
    self_dt: Array        # (R,)
    ia_row: Array         # (Ei,) row in [0, R); R = padding
    ia_col: Array         # (Ei,) column in [0, P)
    ia_loc: Array         # (Ei,)
    ia_feat: Array        # (Ei,)
    ia_dt: Array          # (Ei,)
    mw_node: Array
    mw_slot: Array
    mw_partner: Array
    mw_t: Array
    mw_eid: Array
    # gnn.layer > 1: the same-block root slot of each cache / intra in-edge,
    # or -1 (data/packer.py nbr_rslot; the self column is the row's own
    # slot, rebuilt on the device).  None at one layer.
    cache_rslot: Optional[Array] = None   # (R, K)
    ia_rslot: Optional[Array] = None      # (Ei,)


class CompactWire(NamedTuple):
    """A WirePack with narrow dtypes: index fields
    ship as uint16/uint8 when their bucket's range fits, ``ia_feat`` as a
    uint16 batch position (``ev_idx[ia_pos]`` on the device), and the
    mailbox plan as one slot array: the packer's plan is identity-indexed,
    so position i is (event i >> 1, direction i & 1) and node, partner, t
    and eid follow from the event arrays."""

    ev_src: Array         # (B,) u16|i32
    ev_dst: Array         # (B,) u16|i32
    ev_t: Array           # (B,) f32
    ev_idx: Array         # (B,) i32 (global msg-table rows)
    ev_valid: Array       # (B,) bool
    ev_neg: Array         # (B,)|(B,M) u16|i32
    ev_src_slot: Array    # (B,) u16|i32
    ev_pos_slot: Array    # (B,) u16|i32
    ev_neg_slot: Array    # (B,)|(B,M) u16|i32
    uniq_nid: Array       # (Ub,) u16|i32
    root_loc: Array       # (R,) u16|i32
    cache_loc: Array      # (R,K) u16|i32
    cache_feat: Array     # (R,K) i32 (global e_id; -1 = empty)
    cache_dt: Array       # (R,K) f32
    self_dt: Array        # (R,) f32
    ia_row: Array         # (Ei,) u16|i32 (R = padding)
    ia_col: Array         # (Ei,) u8|i32
    ia_loc: Array         # (Ei,) u16|i32
    ia_pos: Array         # (Ei,) u16|i32 batch position of the event
    ia_dt: Array          # (Ei,) f32
    mw_slot: Array        # (2B,) u8 (255 = no write) | i32 (-1)
    # gnn.layer > 1: u16 with 0xFFFF for -1 while R - 1 <= 0xFFFE, else
    # i32 with -1; None at one layer
    cache_rslot: Optional[Array] = None   # (R, K)
    ia_rslot: Optional[Array] = None      # (Ei,)


class DedupWire(NamedTuple):
    """The deduplicated narrow wire.  Two facts make
    the shrink exact: the recency cache is pre-batch state, so every root
    slot of one node carries the same cache row (rows ship once per unique
    root node, ``cr_loc``/``cr_feat``, with the slot→row map ``root_cr``);
    and a root slot's intra-batch in-edges are a contiguous window of its
    node's event entries, so the COO becomes per-slot (lo, cnt) windows
    into ``ne_ent`` = [partner uniq-loc, global event row], with the Δt
    values in one prefix-layout list (``ia_dt`` from ``intra_start``)."""

    ev_src: Array         # (B,) u16|i32
    ev_dst: Array         # (B,) u16|i32
    ev_t: Array           # (B,) f32
    ev_idx: Array         # (B,) i32 global msg-table rows
    ev_valid: Array       # (B,) bool
    ev_neg: Array         # (B,)|(B,M) u16|i32
    ev_src_slot: Array    # (B,) u16|i32
    ev_pos_slot: Array    # (B,) u16|i32
    ev_neg_slot: Array    # (B,)|(B,M) u16|i32
    uniq_nid: Array       # (Ub,) u16|i32 (pad = num_nodes)
    root_loc: Array       # (R,) u16|i32 (pad = Ub-1)
    root_cr: Array        # (R,) u16|i32 row in the cr tables
    cr_loc: Array         # (Ur, K) u16|i32 per unique root node
    cr_feat: Array        # (Ur, K) i32 global e_id; -1 = empty
    cache_dt: Optional[Array]   # (R, K) f32; None on an eval-lean wire
    self_dt: Optional[Array]    # (R,) f32; None on an eval-lean wire
    ne_ent: Array         # (2B, 2) i32 [partner uniq-loc, event row]
    intra_lo: Array       # (R,) u16|i32 window start into ne_ent
    intra_cnt: Array      # (R,) u8 window length (≤ P)
    intra_start: Array    # (R,) u16|i32 window start into ia_dt
    ia_dt: Optional[Array]      # (Ei,) f32; None on an eval-lean wire
    mw_slot: Array        # (2B,) u8 (255 = no write) | i32 (-1)
    # --- eval-lean extension (eval_lean_dedup) ---------------------------
    root_blk: Optional[Array] = None    # (R,) u8|u16 block of each slot
    ev_blk: Optional[Array] = None      # (B,) u8|u16 block of each event
    blk_max: Optional[Array] = None     # (NBb,) f32 per-block wipe value
    ev_src_loc: Optional[Array] = None  # (B,) i32 endpoint uniq-locs
    ev_dst_loc: Optional[Array] = None  # (B,) i32
    # --- train-lean extension (train_lean_dedup); blk_max then holds
    # zeros of the block bucket's width
    clock0: Optional[Array] = None      # (Ub,) f32 pre-batch clock rows


def stack_wires(wires):
    """Stack same-shape wires (any wire NamedTuple) along a new leading
    axis, ``None`` fields kept ``None``: the multi-host DyRep step ships
    its ranges' wires as one (parallel/mh_engine.py)."""
    cls = type(wires[0])
    return cls(*((np.stack([getattr(w, f) for w in wires])
                  if getattr(wires[0], f) is not None else None)
                 for f in cls._fields))


def wire_nbytes(wire) -> int:
    """Bytes a wire (or a DevicePack of numpy arrays) ships."""
    return sum(np.asarray(a).nbytes for a in wire if a is not None)


# ------------------------------------------------------------------ host
def pack_to_wire(pack: Pack, num_neighbors: int) -> WirePack:
    """A full numpy Pack compacted into a WirePack (tgb_tgn_dgl_tpu
    ops/wire.py:160): the cache part as (R, K) loc/feat/dt, the self
    column's Δt, the intra part as a COO list whose length is bucketed
    from 2B up (an event feeds every later root slot of its endpoints, so
    it can pass 2B), and at gnn.layer > 1 the rslot of each in-edge."""
    K = num_neighbors
    R = pack.nbr_kind.shape[0]
    B = pack.ev_src.shape[0]
    cache_kind = pack.nbr_kind[:, :K]
    cache_feat = np.where(cache_kind == KIND_CACHE,
                          pack.nbr_feat[:, :K], -1).astype(np.int32)
    rows, cols = np.nonzero(pack.nbr_kind[:, K + 1:] == KIND_INTRA)
    n = len(rows)
    Ei = _bucket_pow2(max(n, 1), lo=2 * B)
    ia_row = np.full(Ei, R, np.int32)
    ia_col = np.zeros(Ei, np.int32)
    ia_loc = np.zeros(Ei, np.int32)
    ia_feat = np.zeros(Ei, np.int32)
    ia_dt = np.zeros(Ei, np.float32)
    ia_row[:n] = rows
    ia_col[:n] = cols
    full_cols = cols + K + 1
    ia_loc[:n] = pack.nbr_loc[rows, full_cols]
    ia_feat[:n] = pack.nbr_feat[rows, full_cols]
    ia_dt[:n] = pack.nbr_dt[rows, full_cols]
    cache_rslot = ia_rslot = None
    if pack.nbr_rslot is not None:
        cache_rslot = np.where(cache_kind == KIND_CACHE,
                               pack.nbr_rslot[:, :K], -1).astype(np.int32)
        ia_rslot = np.full(Ei, -1, np.int32)
        ia_rslot[:n] = pack.nbr_rslot[rows, full_cols]
    return WirePack(
        ev_src=pack.ev_src, ev_dst=pack.ev_dst, ev_t=pack.ev_t,
        ev_idx=pack.ev_idx, ev_valid=pack.ev_valid, ev_neg=pack.ev_neg,
        ev_src_slot=pack.ev_src_slot, ev_pos_slot=pack.ev_pos_slot,
        ev_neg_slot=pack.ev_neg_slot,
        uniq_nid=pack.uniq_nid, root_loc=pack.root_loc,
        cache_loc=pack.nbr_loc[:, :K].astype(np.int32),
        cache_feat=cache_feat, cache_dt=pack.nbr_dt[:, :K],
        self_dt=pack.nbr_dt[:, K],
        ia_row=ia_row, ia_col=ia_col, ia_loc=ia_loc, ia_feat=ia_feat,
        ia_dt=ia_dt,
        mw_node=pack.mw_node, mw_slot=pack.mw_slot,
        mw_partner=pack.mw_partner, mw_t=pack.mw_t, mw_eid=pack.mw_eid,
        cache_rslot=cache_rslot, ia_rslot=ia_rslot)


def compact_wire(wire: WirePack, num_nodes: int, intra_width: int,
                 mailbox_size: int) -> Optional[CompactWire]:
    """Host-side narrowing of a WirePack (numpy).  Returns None when the
    wire is not compactable (event rows not strictly increasing, or a
    mailbox plan that is not identity-indexed); the caller then ships the
    WirePack.  Dtypes depend only on bucket sizes (N, R, Ub, P, S)."""
    N = num_nodes
    B = int(wire.ev_src.shape[0])
    R = int(wire.root_loc.shape[0])
    Ub = int(wire.uniq_nid.shape[0])
    ev_idx = np.asarray(wire.ev_idx)
    ev_src = np.asarray(wire.ev_src)
    ev_dst = np.asarray(wire.ev_dst)

    # --- ia_feat -> batch position (needs strictly increasing ev_idx) ---
    nreal = int(np.asarray(wire.ev_valid).sum())
    evr = ev_idx[:nreal]
    if nreal and not np.all(np.diff(evr) > 0):
        return None
    ia_row = np.asarray(wire.ia_row)
    real = ia_row != R
    pos = np.zeros(ia_row.shape[0], np.int64)
    if real.any():
        if nreal == 0:
            return None
        p = np.minimum(np.searchsorted(evr, wire.ia_feat[real]), nreal - 1)
        if not np.array_equal(evr[p], wire.ia_feat[real]):
            return None
        pos[real] = p

    # --- the mailbox plan must be identity-indexed ----------------------
    W = int(wire.mw_node.shape[0])
    if W != 2 * B:
        return None
    pw = np.arange(W)
    loc, side = pw >> 1, pw & 1
    node_raw = np.where(side == 0, ev_src[loc], ev_dst[loc])
    part_raw = np.where(side == 0, ev_dst[loc], ev_src[loc])
    mvalid = np.asarray(wire.mw_node) != N
    minv = ~mvalid
    if not (np.array_equal(wire.mw_node[mvalid], node_raw[mvalid])
            and np.array_equal(wire.mw_partner[mvalid], part_raw[mvalid])
            and np.array_equal(wire.mw_t[mvalid],
                               np.asarray(wire.ev_t)[loc][mvalid])
            and np.array_equal(wire.mw_eid[mvalid], ev_idx[loc][mvalid])
            and np.all(wire.mw_partner[minv] == 0)
            and np.all(wire.mw_t[minv] == 0)
            and np.all(wire.mw_eid[minv] == 0)
            and np.all(wire.mw_slot[minv] == 0)):
        return None
    if mailbox_size <= 254:
        mw_slot = np.where(mvalid, wire.mw_slot, 255).astype(np.uint8)
    else:
        mw_slot = np.where(mvalid, wire.mw_slot, -1).astype(np.int32)

    def enc(a, maxval):
        a = np.asarray(a)
        return a.astype(np.uint16 if maxval <= 0xFFFF else np.int32)

    def enc_rslot(a):
        if a is None:
            return None
        a = np.asarray(a)
        if R - 1 <= RSLOT_U16_MAX:
            return np.where(a < 0, RSLOT_NONE_U16, a).astype(np.uint16)
        return a.astype(np.int32)

    return CompactWire(
        ev_src=enc(ev_src, N - 1), ev_dst=enc(ev_dst, N - 1),
        ev_t=np.asarray(wire.ev_t, np.float32),
        ev_idx=ev_idx.astype(np.int32),
        ev_valid=np.asarray(wire.ev_valid, bool),
        ev_neg=enc(wire.ev_neg, N - 1),
        ev_src_slot=enc(wire.ev_src_slot, R - 1),
        ev_pos_slot=enc(wire.ev_pos_slot, R - 1),
        ev_neg_slot=enc(wire.ev_neg_slot, R - 1),
        uniq_nid=enc(wire.uniq_nid, N),
        root_loc=enc(wire.root_loc, Ub - 1),
        cache_loc=enc(wire.cache_loc, Ub - 1),
        cache_feat=np.asarray(wire.cache_feat, np.int32),
        cache_dt=np.asarray(wire.cache_dt, np.float32),
        self_dt=np.asarray(wire.self_dt, np.float32),
        ia_row=enc(ia_row, R),
        ia_col=(np.asarray(wire.ia_col).astype(np.uint8)
                if intra_width <= 256 else
                np.asarray(wire.ia_col, np.int32)),
        ia_loc=enc(wire.ia_loc, Ub - 1),
        ia_pos=enc(pos, B - 1),
        ia_dt=np.asarray(wire.ia_dt, np.float32),
        mw_slot=mw_slot,
        cache_rslot=enc_rslot(wire.cache_rslot),
        ia_rslot=enc_rslot(wire.ia_rslot),
    )


def nb_bucket_of(blocks) -> int:
    """Pow2 (floor 16) bucket of a split's dependency-block count: the
    width of the eval-lean clock grid, fixed for a whole pass."""
    nb_max = int(blocks.max()) + 1 if len(blocks) else 1
    b = 16
    while b < nb_max:
        b *= 2
    return b


def _lean_block_meta(wire: DedupWire, blocks, nb_bucket: int):
    """Per-event and per-root-slot block ids (u8 for buckets ≤ 256, else
    u16), scattered through the slot maps: every root is referenced by an
    event of its own block.  Returns (ev_blk, root_blk, src_slot,
    pos_slot), or None when the block count overflows the id field."""
    braw = len(blocks)
    blocks = np.asarray(blocks)
    nb = int(blocks.max()) + 1
    if nb > min(nb_bucket, 65536):
        return None
    blk_dt = np.uint8 if nb_bucket <= 256 else np.uint16
    B = np.asarray(wire.ev_t).shape[0]
    R = np.asarray(wire.root_loc).shape[0]
    ev_blk = np.zeros(B, blk_dt)
    ev_blk[:braw] = blocks.astype(blk_dt)
    root_blk = np.zeros(R, blk_dt)
    src_slot = np.asarray(wire.ev_src_slot, np.int64)
    pos_slot = np.asarray(wire.ev_pos_slot, np.int64)
    root_blk[src_slot[:braw]] = ev_blk[:braw]
    root_blk[pos_slot[:braw]] = ev_blk[:braw]
    neg_slot = np.asarray(wire.ev_neg_slot, np.int64)
    root_blk[neg_slot.reshape(B, -1)[:braw]] = ev_blk[:braw, None]
    return ev_blk, root_blk, src_slot, pos_slot


def eval_lean_dedup(wire: DedupWire, blocks, nb_bucket: int) -> DedupWire:
    """Host post-pass for EVAL dedup wires: drop the three Δt fields
    (cache_dt, self_dt, ia_dt: the largest fields of an M=999 chunk) and
    attach the block metadata from which expand_dedup derives them
    bit-exactly on the device.  ``blocks`` is the chunk's (B_raw,) block
    array, ``nb_bucket`` the pass's block-count bucket.  Returns the wire
    unchanged when the block count overflows the id field, or when an
    event time is negative (the device clock grid uses -1 for "no
    event")."""
    braw = len(blocks)
    if braw == 0:
        return wire
    blocks = np.asarray(blocks)
    t = np.asarray(wire.ev_t)[:braw]
    if t.min() < 0:
        return wire
    meta = _lean_block_meta(wire, blocks, nb_bucket)
    if meta is None:
        return wire
    ev_blk, root_blk, src_slot, pos_slot = meta
    R = np.asarray(wire.root_loc).shape[0]
    # per-block wipe value = the block's max event time (data/packer.py:366)
    blk_max = np.zeros(nb_bucket, np.float32)
    np.maximum.at(blk_max, blocks, t)
    root_loc = np.asarray(wire.root_loc, np.int64)
    ev_src_loc = root_loc[np.clip(src_slot, 0, R - 1)].astype(np.int32)
    ev_dst_loc = root_loc[np.clip(pos_slot, 0, R - 1)].astype(np.int32)
    return wire._replace(cache_dt=None, self_dt=None, ia_dt=None,
                         root_blk=root_blk, ev_blk=ev_blk,
                         blk_max=blk_max, ev_src_loc=ev_src_loc,
                         ev_dst_loc=ev_dst_loc)


def train_lean_dedup(wire: DedupWire, blocks, nb_bucket: int,
                     clock_before: np.ndarray) -> DedupWire:
    """Host post-pass for TRAIN dedup wires: drop the three Δt fields
    (cache_dt, self_dt, ia_dt) and attach what expand_dedup needs to
    derive them bit-exactly on the device: ``clock0``, the pre-batch
    clocks of the unique table's rows (``clock_before`` is the packer's
    (N,) clock snapshot taken before this batch was packed), and the
    block ids of eval_lean_dedup (u8 or u16 by ``nb_bucket``, the split's
    block-count bucket).  ``blk_max`` holds zeros: it carries the block
    bucket's width, and its zeros tell this wire from an eval-lean one
    on the device.  Returns the wire unchanged where the device could not
    derive the Δt exactly: a block count over the id field, or 3·B·
    nb_bucket at or over 2^31 (each clock write is ordered by the int32
    key blk·3B + role·B + row + 1)."""
    braw = len(blocks)
    if braw == 0:
        return wire
    neg_slot = np.asarray(wire.ev_neg_slot)
    if neg_slot.ndim != 1:
        return wire          # train wires carry one negative per event
    B = np.asarray(wire.ev_t).shape[0]
    if 3 * B * nb_bucket >= 2 ** 31:
        return wire
    meta = _lean_block_meta(wire, blocks, nb_bucket)
    if meta is None:
        return wire
    ev_blk, root_blk, _, _ = meta
    uniq = np.asarray(wire.uniq_nid, np.int64)
    N = clock_before.shape[0]
    clock0 = np.where(uniq >= N, 0.0,
                      np.asarray(clock_before, np.float32)[
                          np.minimum(uniq, N - 1)]).astype(np.float32)
    return wire._replace(cache_dt=None, self_dt=None, ia_dt=None,
                         root_blk=root_blk, ev_blk=ev_blk,
                         blk_max=np.zeros(nb_bucket, np.float32),
                         clock0=clock0)


# ---------------------------------------------------------------- device
_TORCH_DTYPE = {np.dtype(np.bool_): torch.bool,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint16): torch.int16,     # widened after the copy
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.float32): torch.float32}


def wire_to_device(wire, device, *extra):
    """Every field of a wire as a tensor on ``device``, ``None`` fields
    kept ``None`` (the counterpart of data/packer.py::to_device).  The
    fields, and the host arrays of ``extra`` (an eval chunk's negative
    mask), are staged at 16-byte aligned offsets of one host buffer,
    which crosses in one copy and is split into typed views on the
    device: one pinned allocation and one ``non_blocking`` copy, since
    pinning and copying each of a wire's ~25 fields apart cost the host
    about 20 ms an eval chunk on the card's machine.  The caching host
    allocator keeps the pinned buffer alive until its copy has run.  A
    uint16 field crosses as int16 bits and widens to int32 right after the
    copy (torch indexes with no uint16 tensor).  Returns the device wire,
    or (wire, *extra tensors) when ``extra`` is given."""
    device = torch.device(device)
    # np.asarray keeps a 0-d field (the lean wire's wipe_final) 0-d
    arrays = [None if a is None else np.asarray(a)
              for a in (*wire, *extra)]
    arrays = [a if a is None or a.flags.c_contiguous
              else np.ascontiguousarray(a) for a in arrays]
    offsets, size = [], 0
    for a in arrays:
        offsets.append(size)
        if a is not None:
            size += -(-a.nbytes // 16) * 16
    host = torch.empty(size, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    staged = host.numpy()
    for a, o in zip(arrays, offsets):
        if a is not None:
            staged[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)

    def field(a, o):
        if a is None:
            return None
        t = dev[o:o + a.nbytes].view(_TORCH_DTYPE[a.dtype]).view(a.shape)
        if a.dtype == np.uint16:
            t = t.to(torch.int32).bitwise_and_(0xFFFF)
        return t

    out = [field(a, o) for a, o in zip(arrays, offsets)]
    dev_wire = type(wire)(*out[:len(wire)])
    return (dev_wire, *out[len(wire):]) if extra else dev_wire


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def _mw_from_slots(mw_slot, ev_src, ev_dst, ev_t, ev_idx, num_nodes):
    """The identity-indexed mailbox plan from its slots: position i is
    (event i >> 1, direction i & 1).  ``mw_slot`` is u8 (255 = no write,
    S ≤ 254) or i32 (-1).  Returns (mw_node, mw_slot, mw_partner, mw_t,
    mw_eid)."""
    if mw_slot.dtype == torch.uint8:
        mvalid = mw_slot != 255
    else:
        mvalid = mw_slot >= 0
    slot = torch.where(mvalid, _i32(mw_slot), 0)

    def per_direction(a, b):
        return torch.stack([a, b], dim=1).reshape(-1)

    node_raw = per_direction(ev_src, ev_dst)
    part_raw = per_direction(ev_dst, ev_src)
    return (torch.where(mvalid, node_raw, num_nodes), slot,
            torch.where(mvalid, part_raw, 0),
            torch.where(mvalid, per_direction(ev_t, ev_t), 0.0),
            torch.where(mvalid, per_direction(ev_idx, ev_idx), 0))


def _decode_rslot(a, R: int):
    """A CompactWire rslot field on the device -> int32 with -1.  The
    encoding follows from R alone (``compact_wire``): in the u16 one the
    field arrives widened by ``wire_to_device``, so its -1 sentinel reads
    0xFFFF and must become -1 before any gather uses it."""
    if a is None:
        return None
    a = _i32(a)
    if R - 1 <= RSLOT_U16_MAX:
        return torch.where(a == RSLOT_NONE_U16, -1, a)
    return a


def uncompact_wire(cw: CompactWire, num_nodes: int) -> WirePack:
    """Device-side inverse of compact_wire: bit-equal to the WirePack."""
    ev_src, ev_dst, ev_idx = _i32(cw.ev_src), _i32(cw.ev_dst), _i32(cw.ev_idx)
    R = cw.root_loc.shape[0]
    ia_row = _i32(cw.ia_row)
    ia_feat = torch.where(ia_row == R, 0, ev_idx[_i32(cw.ia_pos)])
    mw_node, mw_slot, mw_partner, mw_t, mw_eid = _mw_from_slots(
        cw.mw_slot, ev_src, ev_dst, cw.ev_t, ev_idx, num_nodes)
    return WirePack(
        ev_src=ev_src, ev_dst=ev_dst, ev_t=cw.ev_t, ev_idx=ev_idx,
        ev_valid=cw.ev_valid, ev_neg=_i32(cw.ev_neg),
        ev_src_slot=_i32(cw.ev_src_slot), ev_pos_slot=_i32(cw.ev_pos_slot),
        ev_neg_slot=_i32(cw.ev_neg_slot),
        uniq_nid=_i32(cw.uniq_nid), root_loc=_i32(cw.root_loc),
        cache_loc=_i32(cw.cache_loc), cache_feat=cw.cache_feat,
        cache_dt=cw.cache_dt, self_dt=cw.self_dt,
        ia_row=ia_row, ia_col=_i32(cw.ia_col), ia_loc=_i32(cw.ia_loc),
        ia_feat=ia_feat, ia_dt=cw.ia_dt,
        mw_node=mw_node, mw_slot=mw_slot, mw_partner=mw_partner,
        mw_t=mw_t, mw_eid=mw_eid,
        cache_rslot=_decode_rslot(cw.cache_rslot, R),
        ia_rslot=_decode_rslot(cw.ia_rslot, R),
    )


def _grid(cache_loc, cache_feat, cache_dt, cache_kind, root_loc,
          root_valid, self_dt, intra, uniq_nid, num_nodes, pad_loc):
    """Concatenate the cache columns, the self-loop column and the intra
    columns (``intra`` = (loc, feat, dt, kind), or None when P = 0) into
    the (R, Kp) grids; node ids come from the uniq table (its trash entry
    num_nodes reads as 0, as in the numpy pack).  Returns (nbr_loc,
    nbr_feat, nbr_dt, nbr_kind, nbr_nid, root_nid)."""
    R = root_loc.shape[0]
    zeros = torch.zeros((R, 1), dtype=torch.int32, device=root_loc.device)
    self_kind = root_valid.to(torch.int8) * KIND_SELF
    cols = [[cache_loc, torch.where(root_valid, root_loc, pad_loc)[:, None]],
            [cache_feat, zeros], [cache_dt, self_dt[:, None]],
            [cache_kind, self_kind[:, None]]]
    if intra is not None:
        for c, x in zip(cols, intra):
            c.append(x)
    nbr_loc, nbr_feat, nbr_dt, nbr_kind = (torch.cat(c, dim=1) for c in cols)
    nid_table = torch.where(uniq_nid == num_nodes, 0, uniq_nid)
    nbr_nid = torch.where(nbr_kind != 0, nid_table[nbr_loc], 0)
    root_nid = torch.where(root_valid, nid_table[root_loc], 0)
    return nbr_loc, nbr_feat, nbr_dt, nbr_kind, nbr_nid, root_nid


def expand_dedup(wire: DedupWire, num_neighbors: int, intra_width: int,
                 num_nodes: int, ev_times=None) -> DevicePack:
    """The full DevicePack from a DedupWire, with gathers (and, on a lean
    wire, one scatter-max).  Bit-equal to ``to_device`` of the numpy pack.

    TRAIN-LEAN wires (``wire.clock0`` set, from train_lean_dedup) carry no
    Δt either.  The packer's train clock (data/packer.py, pass 2) writes
    per block neg, then dst, then src, the last write winning, and a root
    slot reads the clock after its own block.  Each write gets the order
    key blk·3B + role·B + row + 1 (0 = never written): the largest key in
    a (node, block) cell is the block's last write, and since the block
    leads the key, a running max along the blocks (``torch.cummax``)
    gives the last write in blocks ≤ b.  One ``scatter_reduce_`` "amax"
    fills the (Ub, NBb) key grid (max does not depend on the order of the
    writes); the written value is ``ev_t[(key - 1) mod B]``, and a cell
    never written reads the pre-batch clock ``clock0``.

    EVAL-LEAN wires (``wire.cache_dt is None``, from eval_lean_dedup)
    carry no Δt: every eval Δt is ``edge time − clock_b[node]``, where the
    clock of block b is the block's wipe value (its max event time,
    data/packer.py:366) overwritten by the block's own endpoint writes
    (:369-370).  Edge times are rows of the device's event-time table
    ``ev_times`` at the global event rows in cr_feat / ne_ent[:, 1];
    clock_b[u] is u's max event time within block b when u is an endpoint
    there (a (Ub, NBb) grid filled by one ``scatter_reduce_`` "amax" over
    both event halves, starting at -1; times are sorted, so the max is the
    last write), else ``blk_max[b]``.  Each Δt is then the host's own f32
    subtraction."""
    K, P = num_neighbors, intra_width
    lean_dt = wire.cache_dt is None
    if lean_dt and ev_times is None:
        raise ValueError("an eval-lean DedupWire needs the device's "
                         "event-time table (ev_times)")
    R = wire.root_loc.shape[0]
    Ub = wire.uniq_nid.shape[0]
    pad_loc = Ub - 1
    ev_src, ev_dst, ev_idx = (_i32(wire.ev_src), _i32(wire.ev_dst),
                              _i32(wire.ev_idx))
    root_loc, root_cr = _i32(wire.root_loc), _i32(wire.root_cr)
    root_valid = root_loc != pad_loc
    uniq_nid = _i32(wire.uniq_nid)

    if lean_dt and wire.clock0 is not None:
        NBb = wire.blk_max.shape[0]
        root_blk = wire.root_blk.to(torch.int64)            # (R,)
        ev_blk = wire.ev_blk.to(torch.int32)                # (B,)
        Bq = ev_src.shape[0]
        rows = torch.arange(Bq, dtype=torch.int32, device=ev_blk.device)
        locs = torch.cat([root_loc[_i32(wire.ev_neg_slot).long()],
                          root_loc[_i32(wire.ev_pos_slot).long()],
                          root_loc[_i32(wire.ev_src_slot).long()]])
        keys = torch.cat([torch.where(wire.ev_valid,
                                      ev_blk * (3 * Bq) + role * Bq + rows + 1,
                                      0) for role in range(3)])
        cell = (locs.to(torch.int64) * NBb
                + torch.cat([ev_blk, ev_blk, ev_blk]).to(torch.int64))
        grid = torch.zeros(Ub * NBb, dtype=torch.int32, device=keys.device)
        grid.scatter_reduce_(0, cell, keys, "amax")
        last = torch.cummax(grid.view(Ub, NBb), dim=1).values.reshape(-1)

        def clock_at(loc, blk):
            loc = loc.to(torch.int64)
            pg = last[loc * NBb + blk]
            return torch.where(pg > 0, wire.ev_t[((pg - 1) % Bq).long()],
                               wire.clock0[loc])
    elif lean_dt:
        NBb = wire.blk_max.shape[0]
        root_blk = wire.root_blk.to(torch.int64)            # (R,)
        ev_blk = wire.ev_blk.to(torch.int64)                # (B,)
        tval = torch.where(wire.ev_valid, wire.ev_t, -1.0)
        cell = (torch.cat([wire.ev_dst_loc, wire.ev_src_loc]).to(torch.int64)
                * NBb + torch.cat([ev_blk, ev_blk]))
        grid = torch.full((Ub * NBb,), -1.0, dtype=torch.float32,
                          device=tval.device)
        grid.scatter_reduce_(0, cell, torch.cat([tval, tval]), "amax")

        def clock_at(loc, blk):
            g = grid[loc.to(torch.int64) * NBb + blk]
            return torch.where(g >= 0.0, g, wire.blk_max[blk])

    # ---- cache part (one row per unique root node) ----------------------
    cache_loc = _i32(wire.cr_loc)[root_cr]                 # (R, K)
    cache_feat_raw = wire.cr_feat[root_cr]                 # (R, K) i32
    cache_valid = cache_feat_raw >= 0
    cache_feat = cache_feat_raw.clamp_min(0)
    if lean_dt:
        # padded root slots inherit cr row 0's validity: mask them too
        cache_dt = torch.where(
            cache_valid & root_valid[:, None],
            ev_times[cache_feat] - clock_at(cache_loc, root_blk[:, None]),
            0.0)
    else:
        cache_dt = torch.where(cache_valid, wire.cache_dt, 0.0)
    cache_kind = cache_valid.to(torch.int8) * KIND_CACHE
    cache_loc = torch.where(cache_valid, cache_loc, pad_loc)

    # ---- self column ----------------------------------------------------
    self_dt_raw = (0.0 - clock_at(root_loc, root_blk) if lean_dt
                   else wire.self_dt)
    self_dt = torch.where(root_valid, self_dt_raw, 0.0)

    # ---- intra part (per-slot windows into ne_ent; Δt prefix list) -------
    intra = None
    if P > 0:
        ne = _i32(wire.ne_ent)                   # (2B, 2) [loc, event row]
        cnt = _i32(wire.intra_cnt)
        j = torch.arange(P, dtype=torch.int32, device=ne.device)[None, :]
        ia_valid = j < cnt[:, None]                              # (R, P)
        g = ne[(_i32(wire.intra_lo)[:, None] + j).clamp(0, ne.shape[0] - 1)]
        ia_loc = torch.where(ia_valid, g[..., 0], pad_loc)
        ia_feat = torch.where(ia_valid, g[..., 1], 0)
        if lean_dt:
            ia_dt = torch.where(
                ia_valid,
                ev_times[g[..., 1]] - clock_at(g[..., 0], root_blk[:, None]),
                0.0)
        else:
            didx = (_i32(wire.intra_start)[:, None] + j).clamp(
                0, wire.ia_dt.shape[0] - 1)
            ia_dt = torch.where(ia_valid, wire.ia_dt[didx], 0.0)
        intra = (ia_loc, ia_feat, ia_dt, ia_valid.to(torch.int8) * KIND_INTRA)

    nbr_loc, nbr_feat, nbr_dt, nbr_kind, nbr_nid, root_nid = _grid(
        cache_loc, cache_feat, cache_dt, cache_kind, root_loc, root_valid,
        self_dt, intra, uniq_nid, num_nodes, pad_loc)
    mw_node, mw_slot, mw_partner, mw_t, mw_eid = _mw_from_slots(
        wire.mw_slot, ev_src, ev_dst, wire.ev_t, ev_idx, num_nodes)
    return DevicePack(
        ev_src=ev_src, ev_dst=ev_dst, ev_t=wire.ev_t, ev_idx=ev_idx,
        ev_valid=wire.ev_valid, ev_neg=_i32(wire.ev_neg),
        root_nid=root_nid, root_valid=root_valid,
        nbr_nid=nbr_nid, nbr_dt=nbr_dt, nbr_kind=nbr_kind,
        nbr_feat=nbr_feat,
        ev_src_slot=_i32(wire.ev_src_slot),
        ev_pos_slot=_i32(wire.ev_pos_slot),
        ev_neg_slot=_i32(wire.ev_neg_slot),
        uniq_nid=uniq_nid, root_loc=root_loc, nbr_loc=nbr_loc,
        mw_node=mw_node, mw_slot=mw_slot, mw_partner=mw_partner,
        mw_t=mw_t, mw_eid=mw_eid,
    )


def expand_wire(wire, num_neighbors: int, intra_width: int,
                num_nodes: int) -> DevicePack:
    """The full DevicePack from a WirePack or a CompactWire: the intra COO
    scatters into (R + 1, P) grids whose last row takes the padding (every
    real (row, col) pair is unique).  With the rslot fields (gnn.layer > 1)
    ``nbr_rslot`` is the cache columns, then the self column (the row's own
    slot on valid rows, -1 on padding), then the intra columns scattered
    at -1.  Bit-equal to ``to_device`` of the numpy pack."""
    if isinstance(wire, CompactWire):
        wire = uncompact_wire(wire, num_nodes)
    P = intra_width
    R = wire.root_loc.shape[0]
    pad_loc = wire.uniq_nid.shape[0] - 1
    root_valid = wire.root_loc != pad_loc
    cache_valid = wire.cache_feat >= 0
    self_dt = torch.where(root_valid, wire.self_dt, 0.0)
    intra = None
    if P > 0:
        row, col = wire.ia_row.to(torch.int64), wire.ia_col.to(torch.int64)

        def scatter(init, vals):
            g = torch.full((R + 1, P), init, dtype=vals.dtype,
                           device=vals.device)
            g[row, col] = vals
            return g[:R]

        intra = (scatter(pad_loc, wire.ia_loc), scatter(0, wire.ia_feat),
                 scatter(0.0, wire.ia_dt),
                 scatter(0, torch.full(row.shape, KIND_INTRA,
                                       dtype=torch.int8, device=row.device)))
    nbr_loc, nbr_feat, nbr_dt, nbr_kind, nbr_nid, root_nid = _grid(
        wire.cache_loc, wire.cache_feat.clamp_min(0), wire.cache_dt,
        cache_valid.to(torch.int8) * KIND_CACHE, wire.root_loc, root_valid,
        self_dt, intra, wire.uniq_nid, num_nodes, pad_loc)
    nbr_rslot = None
    if wire.cache_rslot is not None:
        own = torch.arange(R, dtype=torch.int32, device=root_valid.device)
        cols = [wire.cache_rslot, torch.where(root_valid, own, -1)[:, None]]
        if P > 0:
            cols.append(scatter(-1, wire.ia_rslot))
        nbr_rslot = torch.cat(cols, dim=1)
    return DevicePack(
        ev_src=wire.ev_src, ev_dst=wire.ev_dst, ev_t=wire.ev_t,
        ev_idx=wire.ev_idx, ev_valid=wire.ev_valid, ev_neg=wire.ev_neg,
        root_nid=root_nid, root_valid=root_valid,
        nbr_nid=nbr_nid, nbr_dt=nbr_dt, nbr_kind=nbr_kind,
        nbr_feat=nbr_feat,
        ev_src_slot=wire.ev_src_slot, ev_pos_slot=wire.ev_pos_slot,
        ev_neg_slot=wire.ev_neg_slot,
        uniq_nid=wire.uniq_nid, root_loc=wire.root_loc, nbr_loc=nbr_loc,
        mw_node=wire.mw_node, mw_slot=wire.mw_slot,
        mw_partner=wire.mw_partner, mw_t=wire.mw_t, mw_eid=wire.mw_eid,
        nbr_rslot=nbr_rslot,
    )


def expand_any(wire, num_neighbors: int, intra_width: int, num_nodes: int,
               ev_times=None) -> DevicePack:
    """Expand whichever wire format arrived."""
    if isinstance(wire, DedupWire):
        return expand_dedup(wire, num_neighbors, intra_width, num_nodes,
                            ev_times=ev_times)
    return expand_wire(wire, num_neighbors, intra_width, num_nodes)
