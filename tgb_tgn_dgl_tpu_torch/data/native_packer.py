"""NativeStreamPacker: ctypes wrapper over the port's csrc/packer.cpp (the
counterpart of tgb_tgn_dgl_tpu/data/native_packer.py).

The same constructor and state API as data/packer.py::StreamPacker
(``pack``/``insert``/``reset_cache``/``snapshot``/``restore``, which a
checkpoint reads and writes, with the sticky shape buckets'
``bucket_state``/``load_bucket_state``; the state views ``cache_nbr``,
``cache_eid``, ``cache_t``, ``clock``, ``mail_ptr``, which return copies,
and ``load_state``, which the multi-host exchange writes back through;
the row-level state surgery ``set_rows``/``set_clock_rows``/
``set_mail_rows``/``clear_rows`` of the owned exchange's scratch packs,
parallel/owned_state.py), with the
host loops in C++, plus the wire emitters the Engine ships to the device
(ops/wire.py): ``pack_wire`` (with the same-block root slots of the
in-edges at ``layers > 1``), ``pack_wire_dedup`` and the one-deep
pack-ahead ``pack_wire_dedup_submit``/``pack_wire_dedup_fetch``, which
runs the next batch on the library's own worker thread (one layer only,
as in the JAX package), ``pack_history`` (DyGFormer's per-event
histories, ops/wire.py::HistoryWire), and ``clock_snapshot``, the (N,) clocks alone,
which the train-lean wire (ops/wire.py::train_lean_dedup) reads before
each batch.  Every other output is bit-equal to the numpy packer
(tests/test_torch_native_packer.py, tests/test_torch_multilayer.py);
``pack_history``, which the numpy packer lacks, is held to the plain
reference's per-node rule (tests/test_torch_dygformer.py).

The library is built with g++ at the first ``NativeStreamPacker``
(ops/_build.py::host_library); a build that fails raises, and nothing
falls back to the numpy packer (the JAX package's ``make_stream_packer``
does; the port has no such factory).  Bound here are only the entry points
this package calls, the device-cache emitter ``packer_pack_fill_lean``
(data/lean_packer.py) among them.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build
from .packer import Pack, PackerConfig, _bucket_p, _bucket_pow2

_DECLARED = set()


def history_buckets(packer, B: int, M: int, eval_mode: bool) -> None:
    """A history pack's sizes in the packer's sticky table, as the grid
    packs keep theirs, under (M, eval_mode): ``R`` the pair passes of a
    step (B (1 + M): each event against its positive and its M
    negatives) and ``Ub`` the ends whose histories it ships (B (2 + M)).
    Both are fixed by the batch size, so the program reads neither; the
    benchmark's harness reads ``bucket_state()[(1, False)]`` for every
    train cell."""
    key = (M, bool(eval_mode))
    packer._sticky_bucket(key, "R", B * (1 + M))
    packer._sticky_bucket(key, "Ub", B * (2 + M))


def _lib() -> ctypes.CDLL:
    """The packer library, built at first use, its entry points typed."""
    lib = _build.host_library("packer")
    if id(lib) in _DECLARED:
        return lib
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c, vp = ctypes, ctypes.c_void_p
    lib.packer_new.argtypes = [c.c_int64, c.c_int32, c.c_int32]
    lib.packer_new.restype = vp
    lib.packer_free.argtypes = [vp]
    lib.packer_reset.argtypes = [vp]
    lib.packer_get_state.argtypes = [vp, i32p, i64p, f32p, f32p, i64p,
                                     c.POINTER(c.c_int64)]
    lib.packer_get_clock.argtypes = [vp, f32p]
    lib.packer_set_state.argtypes = [vp, i32p, i64p, f32p, f32p, i64p,
                                     c.c_int64]
    lib.packer_insert.argtypes = [vp, i32p, i32p, f32p, i64p, c.c_int64]
    lib.packer_set_rows.argtypes = [vp, i64p, c.c_int64, i32p, i64p, f32p,
                                    f32p]
    lib.packer_set_clock_rows.argtypes = [vp, i64p, c.c_int64, f32p]
    lib.packer_set_mail_rows.argtypes = [vp, i64p, c.c_int64, i64p]
    lib.packer_clear_rows.argtypes = [vp, i64p, c.c_int64, c.c_int32]
    lib.packer_pack_begin.argtypes = [
        vp, i32p, i32p, f32p, i64p, i32p, i32p,
        c.c_int64, c.c_int64, c.c_int32, c.c_int64, i64p]
    lib.packer_pack_fill.argtypes = [
        vp, c.c_int64, c.c_int64, c.c_int64, c.c_int32,
        c.c_int32,                                   # write_mail
        i32p, i32p, f32p, i32p, u8p, i32p,          # events
        i32p, u8p,                                   # roots
        i32p, f32p, i8p, i32p,                       # grid
        i32p, i32p, i32p,                            # slot maps
        c.c_int64, i32p, i32p, i32p,                 # uniq/locs
        i32p, i32p, i32p, f32p, i32p]                # write plan
    lib.packer_pack_fill_wire.argtypes = [
        vp, c.c_int64, c.c_int64, c.c_int32,
        c.c_int32,                                   # write_mail
        i32p, i32p, f32p, i32p, u8p, i32p,          # events
        i32p, i32p, i32p,                            # slot maps
        c.c_int64, i32p, i32p,                       # uniq, root_loc
        i32p, i32p, f32p, f32p,                      # cache + self_dt
        c.c_int64, i32p, i32p, i32p, i32p, f32p,     # intra COO
        i32p, i32p, i32p, f32p, i32p]                # write plan
    # the same with the (R, K) cache and (Ei,) intra rslot outputs
    lib.packer_pack_fill_wire2.argtypes = (
        lib.packer_pack_fill_wire.argtypes + [i32p, i32p])
    lib.packer_pack_fill_wire3.argtypes = [
        vp, c.c_int64, c.c_int64, c.c_int32,
        c.c_int32,                                   # write_mail
        i32p, i32p, f32p, i32p, u8p, i32p,          # events
        i32p, i32p, i32p,                            # slot maps
        c.c_int64, i32p,                             # uniq
        i32p, i32p,                                  # roots loc/cr
        c.c_int64, i32p, i32p,                       # cr tables
        f32p, f32p, c.c_int64, f32p,                 # dt outputs
        i32p, i32p, i32p, i32p,                      # intra ranges
        i32p]                                        # mw_slot
    lib.packer_pack_fill_lean.argtypes = [
        vp, c.c_int64, c.c_int64, c.c_int32,
        c.c_int32,                                   # write_mail
        i32p, i32p, f32p, i32p, u8p, i32p,          # events
        i32p, i32p, i32p,                            # slot maps
        i32p, i32p,                                  # roots nid/blk
        c.c_int64, i32p, i32p, i32p,                 # intra COO
        i32p, i32p, i32p, f32p, i32p,                # write plan
        c.c_int64, i32p, i32p, f32p, u8p,            # clock writes
        c.c_int64, f32p, f32p]                       # wipe
    lib.packer_pack_history.argtypes = [
        vp, i32p, i32p, f32p, i64p, i32p, c.c_int64, c.c_int64, c.c_int64,
        c.c_int32, i32p, u8p, i32p, i32p, f32p, i32p]
    lib.packer_dedup_submit.argtypes = [
        vp, i32p, i32p, f32p, i64p, i32p, i32p,
        c.c_int64, c.c_int64, c.c_int32, c.c_int64,
        c.c_int32, c.c_int32, c.c_int64, c.c_int64, i64p]
    lib.packer_dedup_submit.restype = c.c_int32
    lib.packer_dedup_wait.argtypes = [vp, i64p]
    lib.packer_dedup_read.argtypes = [
        vp, c.c_int64,
        vp, vp, f32p, i32p, u8p, vp,      # events
        vp, vp, vp,                        # slot maps
        vp, vp, vp, vp, i32p,              # uniq/locs/cr
        f32p, f32p, f32p,                  # dt outputs
        i32p, vp, u8p, vp, vp]             # intra + mw
    _DECLARED.add(id(lib))
    return lib


def _enc(a: np.ndarray, maxval: int) -> np.ndarray:
    """Index field narrowing of the dedup wire: uint16 when every value
    fits, else int32."""
    if maxval <= 0xFFFF:
        return a.astype(np.uint16)
    return a if a.dtype == np.int32 else a.astype(np.int32)


class PackerHandle:
    """A handle of the packer library with what both of its emitters keep
    on the host: the sticky shape buckets per (M, eval_mode), as
    StreamPacker keeps them, and the read-back of the handle's state.
    ``NativeStreamPacker`` and the device-cache emitter
    (data/lean_packer.py) build on it."""

    def __init__(self, num_nodes: int, cfg: PackerConfig):
        self._lib = _lib()
        self.N = num_nodes
        self.cfg = cfg
        self._h = self._lib.packer_new(num_nodes, cfg.num_neighbors,
                                       cfg.mailbox_size)
        self._sticky: dict = {}

    def _sticky_bucket(self, key, name: str, value: int) -> int:
        cur = self._sticky.setdefault(key, {})
        cur[name] = max(cur.get(name, 0), value)
        return cur[name]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.packer_free(h)    # waits for the worker, joins it
            self._h = None

    def bucket_state(self) -> dict:
        """A copy of the sticky shape buckets, {(M, eval_mode): {name:
        size}}: the padded sizes the next packs start from.  A checkpoint
        keeps them, so that a resumed run pads its tensors as the run it
        continues does (on the GPU a GEMM's summation order follows its
        shape)."""
        return {k: dict(v) for k, v in self._sticky.items()}

    def load_bucket_state(self, buckets) -> None:
        self._sticky = {tuple(k): dict(v) for k, v in buckets.items()}

    def reset_cache(self) -> None:
        self._lib.packer_reset(self._h)

    def _get_state(self):
        K = self.cfg.num_neighbors
        nbr = np.empty((self.N, K), np.int32)
        eid = np.empty((self.N, K), np.int64)
        t = np.empty((self.N, K), np.float32)
        clock = np.empty(self.N, np.float32)
        ptr = np.empty(self.N, np.int64)
        cur = ctypes.c_int64()
        self._lib.packer_get_state(self._h, nbr, eid, t, clock, ptr,
                                   ctypes.byref(cur))
        return nbr, eid, t, clock, cur.value, ptr

    def _begin(self, src, dst, t, ev_idx, blocks, neg, eval_mode):
        """packer_pack_begin on contiguous copies of the batch; returns its
        sizes (total roots, exact P, U, nnz, unique cache rows, -, 4-aligned
        prefix-list size), M and the sticky-bucket key."""
        Braw = len(src)
        neg2d = np.ascontiguousarray(
            np.asarray(neg, np.int32).reshape(Braw, -1))
        M = neg2d.shape[1]
        cap_p = (-1 if self.cfg.max_intra_block is None
                 else self.cfg.max_intra_block)
        sizes = np.zeros(7, np.int64)
        self._lib.packer_pack_begin(
            self._h, np.ascontiguousarray(src, np.int32),
            np.ascontiguousarray(dst, np.int32),
            np.ascontiguousarray(t, np.float32),
            np.ascontiguousarray(ev_idx, np.int64),
            np.ascontiguousarray(blocks, np.int32), neg2d, Braw, M,
            int(eval_mode), cap_p, sizes)
        return [int(s) for s in sizes], M, (M, bool(eval_mode))

    def _intra_width(self, skey, p_exact: int) -> int:
        cap = self.cfg.max_intra_block
        return (cap if cap is not None
                else self._sticky_bucket(skey, "P", _bucket_p(p_exact)))


class NativeStreamPacker(PackerHandle):
    """API-compatible with StreamPacker; the state lives in C++."""

    def __init__(self, num_nodes: int, cfg: PackerConfig):
        if cfg.strategy != "recent":
            raise NotImplementedError(
                f"the native packer runs the 'recent' strategy only (got "
                f"strategy={cfg.strategy!r})")
        super().__init__(num_nodes, cfg)
        self._async_meta = None

    def clock_snapshot(self) -> np.ndarray:
        """A fresh copy of the (N,) clocks through the clock-only entry
        point: the train-lean wire reads them before every batch, and
        ``snapshot`` would copy the whole (N, K) cache as well.  It waits
        for the worker, so the caller takes it with no job pending."""
        clock = np.empty(self.N, np.float32)
        self._lib.packer_get_clock(self._h, clock)
        return clock

    # StreamPacker's state fields as views: each returns a copy, so a
    # caller that changes one writes it back through load_state
    @property
    def cache_nbr(self) -> np.ndarray:
        return self._get_state()[0]

    @property
    def cache_eid(self) -> np.ndarray:
        return self._get_state()[1]

    @property
    def cache_t(self) -> np.ndarray:
        return self._get_state()[2]

    @property
    def clock(self) -> np.ndarray:
        return self.clock_snapshot()

    @property
    def cur_e_id(self):
        return self._get_state()[4]

    @property
    def mail_ptr(self) -> np.ndarray:
        return self._get_state()[5]

    def snapshot(self):
        """(cache_nbr, cache_eid, cache_t, clock, cur_e_id, mail_ptr), as
        StreamPacker.snapshot orders them."""
        return self._get_state()

    def restore(self, snap) -> None:
        nbr, eid, t, clock, cur, ptr = snap
        self.load_state(nbr, eid, t, clock, cur, ptr)

    def load_state(self, cache_nbr, cache_eid, cache_t, clock, cur_e_id,
                   mail_ptr) -> None:
        self._lib.packer_set_state(
            self._h, np.ascontiguousarray(cache_nbr, np.int32),
            np.ascontiguousarray(cache_eid, np.int64),
            np.ascontiguousarray(cache_t, np.float32),
            np.ascontiguousarray(clock, np.float32),
            np.ascontiguousarray(mail_ptr, np.int64), int(cur_e_id))

    # ------------------------------------------- row-level state surgery
    # The owned exchange's scratch pack (parallel/owned_state.py::
    # pack_with_gathered_state) fills only the rows a pack reads, packs
    # with insert=False and clears them again: O(rows) a pack, not O(N).
    def rows_api_available(self) -> bool:
        return True

    def set_rows(self, nodes, nbr, eid, t, clock) -> None:
        """Cache rows and clocks of ``nodes``."""
        nodes = np.ascontiguousarray(nodes, np.int64)
        if len(nodes):
            self._lib.packer_set_rows(
                self._h, nodes, len(nodes),
                np.ascontiguousarray(nbr, np.int32),
                np.ascontiguousarray(eid, np.int64),
                np.ascontiguousarray(t, np.float32),
                np.ascontiguousarray(clock, np.float32))

    def set_clock_rows(self, nodes, clock) -> None:
        nodes = np.ascontiguousarray(nodes, np.int64)
        if len(nodes):
            self._lib.packer_set_clock_rows(
                self._h, nodes, len(nodes),
                np.ascontiguousarray(clock, np.float32))

    def set_mail_rows(self, nodes, ptr) -> None:
        nodes = np.ascontiguousarray(nodes, np.int64)
        if len(nodes):
            self._lib.packer_set_mail_rows(
                self._h, nodes, len(nodes),
                np.ascontiguousarray(ptr, np.int64))

    def clear_rows(self, nodes, zero_all_clocks: bool = False) -> None:
        """Put the rows of ``nodes`` back to a fresh packer's (empty cache,
        clock 0, ring pointer 0); ``zero_all_clocks`` zeroes every clock,
        which an eval-mode pack's clock wipe has written."""
        nodes = np.ascontiguousarray(nodes, np.int64)
        self._lib.packer_clear_rows(self._h, nodes, len(nodes),
                                    int(zero_all_clocks))

    def insert(self, src, dst, t, e_id=None) -> None:
        b = len(src)
        if b == 0:
            return
        if e_id is None:
            e_id = self.cur_e_id + np.arange(b, dtype=np.int64)
        self._lib.packer_insert(
            self._h, np.ascontiguousarray(src, np.int32),
            np.ascontiguousarray(dst, np.int32),
            np.ascontiguousarray(t, np.float32),
            np.ascontiguousarray(e_id, np.int64), b)

    # -------------------------------------------------------------- pack
    def _root_buckets(self, skey, total_roots: int, U: int):
        lo = self.cfg.root_bucket_lo
        R = self._sticky_bucket(skey, "R", _bucket_pow2(max(total_roots, 1),
                                                        lo))
        Ub = self._sticky_bucket(skey, "Ub", _bucket_pow2(U + 1, lo))
        return R, Ub

    def pack(self, src, dst, t, ev_idx, blocks, neg,
             eval_mode: bool = False, insert: bool = True,
             write_mail: bool = True) -> Pack:
        """The full-grid Pack, as StreamPacker.pack returns it."""
        assert self.cfg.layers == 1, (
            "the native full-grid pack() emits no nbr_rslot; pack_wire "
            "does at layers > 1")
        cfg = self.cfg
        K = cfg.num_neighbors
        Braw = len(src)
        B = cfg.batch_size
        sizes, M, skey = self._begin(src, dst, t, ev_idx, blocks, neg,
                                     eval_mode)
        total_roots, p_exact, U = sizes[0], sizes[1], sizes[2]
        P = self._intra_width(skey, p_exact)
        Kp = K + 1 + P
        R, Ub = self._root_buckets(skey, total_roots, U)
        W = 2 * B
        ev_src, ev_dst = np.empty(B, np.int32), np.empty(B, np.int32)
        ev_t, ev_idx_out = np.empty(B, np.float32), np.empty(B, np.int32)
        ev_valid = np.empty(B, np.uint8)
        ev_neg = np.empty((B, M), np.int32)
        root_nid, root_valid = np.empty(R, np.int32), np.empty(R, np.uint8)
        nbr_nid = np.empty((R, Kp), np.int32)
        nbr_dt = np.empty((R, Kp), np.float32)
        nbr_kind = np.empty((R, Kp), np.int8)
        nbr_feat = np.empty((R, Kp), np.int32)
        ev_src_slot = np.empty(B, np.int32)
        ev_pos_slot = np.empty(B, np.int32)
        ev_neg_slot = np.empty((B, M), np.int32)
        uniq_nid = np.empty(Ub, np.int32)
        root_loc = np.empty(R, np.int32)
        nbr_loc = np.empty((R, Kp), np.int32)
        mw_node, mw_slot = np.empty(W, np.int32), np.empty(W, np.int32)
        mw_partner, mw_eid = np.empty(W, np.int32), np.empty(W, np.int32)
        mw_t = np.empty(W, np.float32)
        self._lib.packer_pack_fill(
            self._h, B, R, P, int(insert), int(write_mail),
            ev_src, ev_dst, ev_t, ev_idx_out, ev_valid, ev_neg,
            root_nid, root_valid,
            nbr_nid, nbr_dt, nbr_kind, nbr_feat,
            ev_src_slot, ev_pos_slot, ev_neg_slot,
            Ub, uniq_nid, root_loc, nbr_loc,
            mw_node, mw_slot, mw_partner, mw_t, mw_eid)
        blocks = np.asarray(blocks)
        return Pack(
            ev_src=ev_src, ev_dst=ev_dst, ev_t=ev_t, ev_idx=ev_idx_out,
            ev_valid=ev_valid.astype(bool),
            ev_neg=ev_neg if M > 1 else ev_neg[:, 0],
            root_nid=root_nid, root_valid=root_valid.astype(bool),
            nbr_nid=nbr_nid, nbr_dt=nbr_dt, nbr_kind=nbr_kind,
            nbr_feat=nbr_feat,
            ev_src_slot=ev_src_slot, ev_pos_slot=ev_pos_slot,
            ev_neg_slot=ev_neg_slot if M > 1 else ev_neg_slot[:, 0],
            uniq_nid=uniq_nid, root_loc=root_loc, nbr_loc=nbr_loc,
            mw_node=mw_node, mw_slot=mw_slot, mw_partner=mw_partner,
            mw_t=mw_t, mw_eid=mw_eid,
            num_blocks=int(blocks.max()) + 1 if Braw else 0,
            num_real_events=Braw,
            num_real_roots=total_roots,
        )

    def pack_wire(self, src, dst, t, ev_idx, blocks, neg,
                  eval_mode: bool = False, insert: bool = True,
                  write_mail: bool = True):
        """Pack one batch straight into a WirePack (no full grids on the
        host), with ``cache_rslot``/``ia_rslot`` at ``layers > 1``.
        Returns (WirePack, intra_width)."""
        from ..ops.wire import WirePack

        cfg = self.cfg
        K = cfg.num_neighbors
        B = cfg.batch_size
        sizes, M, skey = self._begin(src, dst, t, ev_idx, blocks, neg,
                                     eval_mode)
        total_roots, p_exact, U, nnz = sizes[0], sizes[1], sizes[2], sizes[3]
        P = self._intra_width(skey, p_exact)
        R, Ub = self._root_buckets(skey, total_roots, U)
        Ei = self._sticky_bucket(skey, "Ei",
                                 _bucket_pow2(max(nnz, 1), lo=2 * B))
        W = 2 * B
        ev_src, ev_dst = np.empty(B, np.int32), np.empty(B, np.int32)
        ev_t, ev_idx_out = np.empty(B, np.float32), np.empty(B, np.int32)
        ev_valid = np.empty(B, np.uint8)
        ev_neg = np.empty((B, M), np.int32)
        ev_src_slot = np.empty(B, np.int32)
        ev_pos_slot = np.empty(B, np.int32)
        ev_neg_slot = np.empty((B, M), np.int32)
        uniq_nid = np.empty(Ub, np.int32)
        root_loc = np.empty(R, np.int32)
        cache_loc = np.empty((R, K), np.int32)
        cache_feat = np.empty((R, K), np.int32)
        cache_dt = np.empty((R, K), np.float32)
        self_dt = np.empty(R, np.float32)
        ia_row, ia_col = np.empty(Ei, np.int32), np.empty(Ei, np.int32)
        ia_loc, ia_feat = np.empty(Ei, np.int32), np.empty(Ei, np.int32)
        ia_dt = np.empty(Ei, np.float32)
        mw_node, mw_slot = np.empty(W, np.int32), np.empty(W, np.int32)
        mw_partner, mw_eid = np.empty(W, np.int32), np.empty(W, np.int32)
        mw_t = np.empty(W, np.float32)
        args = [self._h, B, R, int(insert), int(write_mail),
                ev_src, ev_dst, ev_t, ev_idx_out, ev_valid, ev_neg,
                ev_src_slot, ev_pos_slot, ev_neg_slot,
                Ub, uniq_nid, root_loc,
                cache_loc, cache_feat, cache_dt, self_dt,
                Ei, ia_row, ia_col, ia_loc, ia_feat, ia_dt,
                mw_node, mw_slot, mw_partner, mw_t, mw_eid]
        cache_rslot = ia_rslot = None
        if cfg.layers > 1:
            cache_rslot = np.empty((R, K), np.int32)
            ia_rslot = np.empty(Ei, np.int32)
            self._lib.packer_pack_fill_wire2(*args, cache_rslot, ia_rslot)
        else:
            self._lib.packer_pack_fill_wire(*args)
        wire = WirePack(
            ev_src=ev_src, ev_dst=ev_dst, ev_t=ev_t, ev_idx=ev_idx_out,
            ev_valid=ev_valid.astype(bool),
            ev_neg=ev_neg if M > 1 else ev_neg[:, 0],
            ev_src_slot=ev_src_slot, ev_pos_slot=ev_pos_slot,
            ev_neg_slot=ev_neg_slot if M > 1 else ev_neg_slot[:, 0],
            uniq_nid=uniq_nid, root_loc=root_loc,
            cache_loc=cache_loc, cache_feat=cache_feat, cache_dt=cache_dt,
            self_dt=self_dt,
            ia_row=ia_row, ia_col=ia_col, ia_loc=ia_loc, ia_feat=ia_feat,
            ia_dt=ia_dt,
            mw_node=mw_node, mw_slot=mw_slot, mw_partner=mw_partner,
            mw_t=mw_t, mw_eid=mw_eid,
            cache_rslot=cache_rslot, ia_rslot=ia_rslot,
        )
        return wire, P

    def pack_wire_dedup(self, src, dst, t, ev_idx, blocks, neg,
                        eval_mode: bool = False, insert: bool = True,
                        write_mail: bool = True):
        """Pack one batch straight into a DedupWire (ops/wire.py): C++
        fills int32/float32 buffers, and the index fields narrow to uint16
        where their bucket's range fits.  Returns (DedupWire,
        intra_width), or None when the batch cannot take this wire (empty,
        over the batch size, or P > 255: the intra counts ship as u8);
        the stream state is then untouched and the caller packs a
        WirePack instead."""
        from ..ops.wire import DedupWire

        cfg = self.cfg
        K = cfg.num_neighbors
        Braw = len(src)
        B = cfg.batch_size
        if Braw == 0 or Braw > B:
            return None
        sizes, M, skey = self._begin(src, dst, t, ev_idx, blocks, neg,
                                     eval_mode)
        total_roots, p_exact, U, n_ur = sizes[0], sizes[1], sizes[2], sizes[4]
        nnz4 = sizes[6]      # 4-aligned prefix-list size (row gathers)
        P = self._intra_width(skey, p_exact)
        if P > 255:
            return None
        R, Ub = self._root_buckets(skey, total_roots, U)
        Ur = self._sticky_bucket(
            skey, "Ur", _bucket_pow2(n_ur + 1, cfg.root_bucket_lo))
        Ei = self._sticky_bucket(skey, "Ei",
                                 _bucket_pow2(max(nnz4, 4), lo=2 * B))
        ev_src, ev_dst = np.empty(B, np.int32), np.empty(B, np.int32)
        ev_t, ev_idx_out = np.empty(B, np.float32), np.empty(B, np.int32)
        ev_valid = np.empty(B, np.uint8)
        ev_neg = np.empty((B, M), np.int32)
        ev_src_slot = np.empty(B, np.int32)
        ev_pos_slot = np.empty(B, np.int32)
        ev_neg_slot = np.empty((B, M), np.int32)
        uniq_nid = np.empty(Ub, np.int32)
        root_loc, root_cr = np.empty(R, np.int32), np.empty(R, np.int32)
        cr_loc = np.empty((Ur, K), np.int32)
        cr_feat = np.empty((Ur, K), np.int32)
        cache_dt = np.empty((R, K), np.float32)
        self_dt = np.empty(R, np.float32)
        ia_dt = np.empty(Ei, np.float32)
        ne_ent = np.empty((2 * B, 2), np.int32)
        intra_lo, intra_cnt = np.empty(R, np.int32), np.empty(R, np.int32)
        intra_start = np.empty(R, np.int32)
        mw_slot = np.empty(2 * B, np.int32)
        self._lib.packer_pack_fill_wire3(
            self._h, B, R, int(insert), int(write_mail),
            ev_src, ev_dst, ev_t, ev_idx_out, ev_valid, ev_neg,
            ev_src_slot, ev_pos_slot, ev_neg_slot,
            Ub, uniq_nid, root_loc, root_cr,
            Ur, cr_loc, cr_feat,
            cache_dt, self_dt, Ei, ia_dt,
            ne_ent, intra_lo, intra_cnt, intra_start,
            mw_slot)
        N = self.N
        if cfg.mailbox_size <= 254:
            mw_out = np.where(mw_slot >= 0, mw_slot, 255).astype(np.uint8)
        else:
            mw_out = mw_slot
        wire = DedupWire(
            ev_src=_enc(ev_src, N - 1), ev_dst=_enc(ev_dst, N - 1),
            ev_t=ev_t, ev_idx=ev_idx_out,
            ev_valid=ev_valid.astype(bool),
            ev_neg=_enc(ev_neg if M > 1 else ev_neg[:, 0], N - 1),
            ev_src_slot=_enc(ev_src_slot, R - 1),
            ev_pos_slot=_enc(ev_pos_slot, R - 1),
            ev_neg_slot=_enc(ev_neg_slot if M > 1 else ev_neg_slot[:, 0],
                             R - 1),
            uniq_nid=_enc(uniq_nid, N),
            root_loc=_enc(root_loc, Ub - 1),
            root_cr=_enc(root_cr, Ur - 1),
            cr_loc=_enc(cr_loc, Ub - 1),
            cr_feat=cr_feat, cache_dt=cache_dt, self_dt=self_dt,
            ne_ent=ne_ent,
            intra_lo=_enc(intra_lo, 2 * B - 1),
            intra_cnt=intra_cnt.astype(np.uint8),
            intra_start=_enc(intra_start, Ei - 1),
            ia_dt=ia_dt, mw_slot=mw_out,
        )
        return wire, P

    def pack_history(self, src, dst, t, ev_idx, blocks, neg,
                     eval_mode: bool = False, insert: bool = True,
                     write_mail: bool = True):
        """(HistoryWire, 0): DyGFormer's per-event histories from the
        recency cache, on this thread.  Event by event in stream order,
        each end (src, dst, then the negatives) reads its cache row, whose
        K entries are its latest interactions earlier in the stream,
        oldest first, with Δt = t_event - t_edge; then the event is
        inserted.  ``insert=False`` leaves the cache and the event cursor
        as they were.  ``blocks`` and ``write_mail`` are the pack's
        arguments that this mode has no use for."""
        from ..ops.wire import HistoryWire

        Braw, B, K = len(src), self.cfg.batch_size, self.cfg.num_neighbors
        neg2d = np.ascontiguousarray(
            np.asarray(neg, np.int32).reshape(Braw, -1))
        M = neg2d.shape[1]
        E = 2 + M
        history_buckets(self, B, M, eval_mode)
        end = np.empty((B, E), np.int32)
        valid = np.empty(B, np.uint8)
        nid = np.empty((B, E, K), np.int32)
        eid = np.empty((B, E, K), np.int32)
        dt = np.empty((B, E, K), np.float32)
        n_of = np.empty((B, E), np.int32)
        self._lib.packer_pack_history(
            self._h, np.ascontiguousarray(src, np.int32),
            np.ascontiguousarray(dst, np.int32),
            np.ascontiguousarray(t, np.float32),
            np.ascontiguousarray(ev_idx, np.int64), neg2d, Braw, M, B,
            int(insert), end, valid, nid, eid, dt, n_of)
        return HistoryWire(ev_end=end, ev_valid=valid.astype(bool),
                           hist_nid=nid, hist_eid=eid, hist_dt=dt,
                           hist_len=n_of), 0

    # --------------------------------------------------- async pack-ahead
    # One job at most is outstanding: submit hands the batch to the C++
    # worker thread, which packs it (advancing the stream state) while the
    # caller dispatches the previous batch; fetch waits for it and narrows
    # the dtypes as pack_wire_dedup does.  Every synchronous entry point
    # waits for the worker first (csrc/packer.cpp wait_idle), so sync calls
    # may be interleaved.
    def pack_wire_dedup_submit(self, src, dst, t, ev_idx, blocks, neg,
                               eval_mode: bool = False, insert: bool = True,
                               write_mail: bool = True) -> bool:
        """Start packing on the C++ worker.  Returns False when the batch
        cannot take the dedup wire at all: empty, over the batch size, or
        ``layers > 1`` (the dedup wire carries no rslot); the caller then
        packs it synchronously.  P > 255 shows at fetch."""
        cfg = self.cfg
        Braw = len(src)
        if Braw == 0 or Braw > cfg.batch_size or cfg.layers != 1:
            return False
        neg2d = np.ascontiguousarray(
            np.asarray(neg, np.int32).reshape(Braw, -1))
        M = neg2d.shape[1]
        skey = (M, bool(eval_mode))
        st = self._sticky.get(skey, {})
        sticky5 = np.asarray([st.get(k, 0) for k in
                              ("P", "R", "Ub", "Ur", "Ei")], np.int64)
        cap_p = -1 if cfg.max_intra_block is None else cfg.max_intra_block
        self._lib.packer_dedup_submit(
            self._h, np.ascontiguousarray(src, np.int32),
            np.ascontiguousarray(dst, np.int32),
            np.ascontiguousarray(t, np.float32),
            np.ascontiguousarray(ev_idx, np.int64),
            np.ascontiguousarray(blocks, np.int32), neg2d,
            Braw, M, int(eval_mode), cap_p, int(insert), int(write_mail),
            cfg.batch_size, cfg.root_bucket_lo, sticky5)
        self._async_meta = skey
        return True

    def pack_wire_dedup_fetch(self):
        """(DedupWire, intra_width) of the submitted job in freshly
        allocated arrays, or None when the worker found P > 255 (the state
        is untouched: the caller packs the SAME batch synchronously with
        pack_wire)."""
        from ..ops.wire import DedupWire

        dims = np.zeros(6, np.int64)
        self._lib.packer_dedup_wait(self._h, dims)
        if dims[0]:
            return None
        P, R, Ub, Ur, Ei = (int(d) for d in dims[1:])
        skey = self._async_meta
        M = skey[0]
        cfg = self.cfg
        # the python sticky table follows the worker's ratchet, so later
        # synchronous packs choose the same buckets
        if cfg.max_intra_block is None:
            self._sticky_bucket(skey, "P", P)
        for name, v in (("R", R), ("Ub", Ub), ("Ur", Ur), ("Ei", Ei)):
            self._sticky_bucket(skey, name, v)
        B = cfg.batch_size
        K = cfg.num_neighbors
        N = self.N
        # one bit per field group that ships as uint16 (_enc's rule)
        narrow = [N - 1, R - 1, N, Ub - 1, Ur - 1, Ub - 1, 2 * B - 1,
                  Ei - 1]
        bits = sum(1 << i for i, m in enumerate(narrow) if m <= 0xFFFF)
        if cfg.mailbox_size <= 254:
            bits |= 256

        def alloc(shape, bit):
            return np.empty(shape, np.uint16 if bits & bit else np.int32)

        ev_src, ev_dst = alloc(B, 1), alloc(B, 1)
        ev_t, ev_idx_out = np.empty(B, np.float32), np.empty(B, np.int32)
        ev_valid = np.empty(B, bool)
        ev_neg = alloc((B, M), 1)
        ev_src_slot, ev_pos_slot = alloc(B, 2), alloc(B, 2)
        ev_neg_slot = alloc((B, M), 2)
        uniq_nid = alloc(Ub, 4)
        root_loc, root_cr = alloc(R, 8), alloc(R, 16)
        cr_loc = alloc((Ur, K), 32)
        cr_feat = np.empty((Ur, K), np.int32)
        cache_dt = np.empty((R, K), np.float32)
        self_dt = np.empty(R, np.float32)
        ia_dt = np.empty(Ei, np.float32)
        ne_ent = np.empty((2 * B, 2), np.int32)
        intra_lo = alloc(R, 64)
        intra_cnt = np.empty(R, np.uint8)
        intra_start = alloc(R, 128)
        mw_slot = np.empty(2 * B, np.uint8 if bits & 256 else np.int32)

        def d(a):
            return a.ctypes.data

        self._lib.packer_dedup_read(
            self._h, bits,
            d(ev_src), d(ev_dst), ev_t, ev_idx_out,
            ev_valid.view(np.uint8), d(ev_neg),
            d(ev_src_slot), d(ev_pos_slot), d(ev_neg_slot),
            d(uniq_nid), d(root_loc), d(root_cr), d(cr_loc), cr_feat,
            cache_dt, self_dt, ia_dt,
            ne_ent, d(intra_lo), intra_cnt, d(intra_start), d(mw_slot))
        wire = DedupWire(
            ev_src=ev_src, ev_dst=ev_dst, ev_t=ev_t, ev_idx=ev_idx_out,
            ev_valid=ev_valid,
            ev_neg=ev_neg if M > 1 else ev_neg[:, 0],
            ev_src_slot=ev_src_slot, ev_pos_slot=ev_pos_slot,
            ev_neg_slot=ev_neg_slot if M > 1 else ev_neg_slot[:, 0],
            uniq_nid=uniq_nid, root_loc=root_loc, root_cr=root_cr,
            cr_loc=cr_loc, cr_feat=cr_feat,
            cache_dt=cache_dt, self_dt=self_dt,
            ne_ent=ne_ent, intra_lo=intra_lo, intra_cnt=intra_cnt,
            intra_start=intra_start, ia_dt=ia_dt, mw_slot=mw_slot,
        )
        return wire, P

