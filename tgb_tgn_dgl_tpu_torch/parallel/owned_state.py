"""Node-range-owned streaming state, the multi-host engine's
``exchange="owned"`` (the port's counterpart of
tgb_tgn_dgl_tpu/parallel/owned_state.py).

The replicated exchange (parallel/multihost.py) keeps every host's packer
state whole: each host replays all ranges of every super-batch, O(all
events) a host.  Here host h keeps the cache, clock and mail rows of its
node range only, and does the heavy per-node work for the events that
touch it; the rows a pack reads travel in a boundary gather.  This is
exact because all three parts of the state are per-node functions of the
stream:

  * node u's cache row is the last-K-by-e_id merge over the events with u
    as an endpoint;
  * clock[u] is the t of the last write to u in the serial block order
    (negatives → dst → src per block), or the batch's block maximum under
    the eval wipe;
  * mail_ptr[u] advances a batch by min(#touches(u), S).

``NodeRangeOwnedState`` (numpy) is the plain version the tests hold
``NativeNodeRangeOwnedState`` (csrc/owned_state.cpp, built with
``ops/_build.py::host_library`` at its first use) against; the engine uses
the native one.  ``pack_with_gathered_state`` packs a batch on a scratch
packer filled with the gathered rows, bit-equal to a pack on the whole
serial state; ``restore_serial_from_owners`` hands the serial packer its
whole state back.  ``DistributedOwnerExchange`` is the owners across
processes: each process holds one owner, and the gathers resolve over an
injected all-gather (``multihost.multihost_allgather``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from ..ops import _build

_DECLARED = set()


def _owned_lib() -> ctypes.CDLL:
    """The owned-state library, built at first use, its entry points
    typed."""
    lib = _build.host_library("owned_state")
    if id(lib) in _DECLARED:
        return lib
    c = ctypes
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.owned_new.argtypes = [c.c_int64, c.c_int64, c.c_int64, c.c_int32,
                              c.c_int32]
    lib.owned_new.restype = c.c_void_p
    lib.owned_free.argtypes = [c.c_void_p]
    lib.owned_apply_batch.argtypes = [
        c.c_void_p, i32p, i32p, f32p, i64p, i32p, i32p,
        c.c_int64, c.c_int64, c.c_int32]
    lib.owned_get_rows.argtypes = [
        c.c_void_p, i64p, c.c_int64, i32p, i64p, f32p, f32p, u8p]
    lib.owned_get_mail.argtypes = [c.c_void_p, i64p, c.c_int64, i64p, u8p]
    lib.owned_reset_cache.argtypes = [c.c_void_p]
    lib.owned_load_from_serial.argtypes = [
        c.c_void_p, i32p, i64p, f32p, f32p, i64p]
    lib.owned_get_state.argtypes = [
        c.c_void_p, i32p, i64p, f32p, f32p, i64p, c.POINTER(c.c_int64)]
    _DECLARED.add(id(lib))
    return lib


class NodeRangeOwnedState:
    """Host h's authoritative stream state for nodes [lo, hi), numpy.

    The state half of data/packer.py::StreamPacker filtered to the owned
    range; ``apply_batch`` consumes one batch of the whole stream (every
    host sees the gathered super-batch) and does the per-node work of its
    own rows only."""

    def __init__(self, num_nodes: int, n_hosts: int, host: int, K: int,
                 S: int):
        self.N = num_nodes
        self.lo = host * num_nodes // n_hosts
        self.hi = (host + 1) * num_nodes // n_hosts
        n_own = self.hi - self.lo
        self.K = K
        self.S = S
        self.cache_nbr = np.zeros((n_own, K), np.int32)
        self.cache_eid = np.full((n_own, K), -1, np.int64)
        self.cache_t = np.full((n_own, K), -1.0, np.float32)
        self.clock = np.zeros(n_own, np.float32)
        self.mail_ptr = np.zeros(n_own, np.int64)
        # cache-merge entries processed (the heavy work of a replay)
        self.merge_entries = 0

    def _own(self, nodes: np.ndarray) -> np.ndarray:
        return (nodes >= self.lo) & (nodes < self.hi)

    def apply_batch(self, src, dst, t, blocks, neg, e_id,
                    eval_mode: bool = False) -> None:
        """Consume one batch of the stream in serial semantics, updating
        the owned rows only.  ``neg`` is (B,) or (B, M)."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        t = np.asarray(t, np.float32)
        blocks = np.asarray(blocks, np.int64)
        e_id = np.asarray(e_id, np.int64)
        B = len(src)
        if B == 0:
            return
        neg2d = np.asarray(neg, np.int64).reshape(B, -1)
        M = neg2d.shape[1]

        # clocks: the serial per-block order, the eval wipe or the
        # negatives' writes, then dst, then src (fancy assignment keeps
        # the last occurrence, as the serial packer does)
        def write(nodes, vals):
            own = self._own(nodes)
            self.clock[nodes[own] - self.lo] = vals[own]

        for i in range(int(blocks.max()) + 1):
            sel = np.nonzero(blocks == i)[0]
            ti = t[sel]
            if eval_mode:
                if len(ti):
                    self.clock[:] = ti.max()
            else:
                write(neg2d[sel].ravel(), np.repeat(ti, M))
            write(dst[sel], ti)
            write(src[sel], ti)

        # ring pointers: advance by min(count, S) per owned node
        mn = np.concatenate([src, dst])
        own = self._own(mn)
        uniq, counts = np.unique(mn[own], return_counts=True)
        kept = np.minimum(counts, self.S)
        idx = uniq - self.lo
        self.mail_ptr[idx] = (self.mail_ptr[idx] + kept) % self.S

        # cache rows: last-K-by-eid merge for the owned endpoints (the
        # candidate order of StreamPacker.insert: the dst half before the
        # src half on an equal eid, the cache wins ties)
        nodes2 = np.concatenate([dst, src])
        nbrs2 = np.concatenate([src, dst]).astype(np.int32)
        eids2 = np.concatenate([e_id, e_id])
        tt2 = np.concatenate([t, t])
        half = np.concatenate([np.zeros(B, np.int8), np.ones(B, np.int8)])
        own = self._own(nodes2)
        nodes2, nbrs2, eids2, tt2, half = (
            nodes2[own], nbrs2[own], eids2[own], tt2[own], half[own])
        self.merge_entries += len(nodes2)
        order = np.lexsort((half, eids2, nodes2))
        nodes2, nbrs2, eids2, tt2 = (nodes2[order], nbrs2[order],
                                     eids2[order], tt2[order])
        uniq, starts = np.unique(nodes2, return_index=True)
        ends = np.append(starts[1:], len(nodes2))
        K = self.K
        for u, a, b in zip(uniq, starts, ends):
            r = u - self.lo
            lo2 = max(a, b - K)
            cat_e = np.concatenate([self.cache_eid[r], eids2[lo2:b]])
            cat_n = np.concatenate([self.cache_nbr[r], nbrs2[lo2:b]])
            cat_t = np.concatenate([self.cache_t[r], tt2[lo2:b]])
            top = np.argsort(-cat_e, kind="stable")[:K]
            self.cache_eid[r] = cat_e[top]
            self.cache_nbr[r] = cat_n[top]
            self.cache_t[r] = cat_t[top]

    def get_rows(self, nodes: np.ndarray):
        """(nbr (n, K), eid, t, clock (n,), owned (n,)) of any node set;
        rows outside the owned range are the empty defaults with owned
        False."""
        nodes = np.asarray(nodes, np.int64)
        n = len(nodes)
        K = self.K
        nbr = np.zeros((n, K), np.int32)
        eid = np.full((n, K), -1, np.int64)
        tt = np.full((n, K), -1.0, np.float32)
        clock = np.zeros(n, np.float32)
        m = self._own(nodes)
        idx = nodes[m] - self.lo
        nbr[m] = self.cache_nbr[idx]
        eid[m] = self.cache_eid[idx]
        tt[m] = self.cache_t[idx]
        clock[m] = self.clock[idx]
        return nbr, eid, tt, clock, m

    def get_mail(self, nodes: np.ndarray):
        """(mail_ptr (n,), owned (n,)) of any node set."""
        nodes = np.asarray(nodes, np.int64)
        ptr = np.zeros(len(nodes), np.int64)
        m = self._own(nodes)
        ptr[m] = self.mail_ptr[nodes[m] - self.lo]
        return ptr, m

    def reset_cache(self) -> None:
        """Train-epoch start: cache and ring pointers clear, clocks
        persist (StreamPacker.reset_cache)."""
        self.cache_eid.fill(-1)
        self.cache_t.fill(-1.0)
        self.mail_ptr.fill(0)

    def load_from_serial(self, packer) -> None:
        """Take the owned rows of a serial packer's state (after a phase
        run serially, the epoch tail or an eval pass, advanced it)."""
        sl = slice(self.lo, self.hi)
        self.cache_nbr[:] = np.asarray(packer.cache_nbr)[sl]
        self.cache_eid[:] = np.asarray(packer.cache_eid)[sl]
        self.cache_t[:] = np.asarray(packer.cache_t)[sl]
        self.clock[:] = np.asarray(packer.clock)[sl]
        self.mail_ptr[:] = np.asarray(packer.mail_ptr)[sl]


class NativeNodeRangeOwnedState:
    """``NodeRangeOwnedState`` with its loops in C++
    (csrc/owned_state.cpp): the same API, the state views returning
    copies."""

    def __init__(self, num_nodes: int, n_hosts: int, host: int, K: int,
                 S: int):
        self._lib = _owned_lib()
        self.N = num_nodes
        self.lo = host * num_nodes // n_hosts
        self.hi = (host + 1) * num_nodes // n_hosts
        self.K = K
        self.S = S
        self._h = self._lib.owned_new(num_nodes, self.lo, self.hi, K, S)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.owned_free(h)
            self._h = None

    def apply_batch(self, src, dst, t, blocks, neg, e_id,
                    eval_mode: bool = False) -> None:
        B = len(src)
        if B == 0:
            return
        neg2d = np.ascontiguousarray(np.asarray(neg, np.int32).reshape(B, -1))
        self._lib.owned_apply_batch(
            self._h, np.ascontiguousarray(src, np.int32),
            np.ascontiguousarray(dst, np.int32),
            np.ascontiguousarray(t, np.float32),
            np.ascontiguousarray(e_id, np.int64),
            np.ascontiguousarray(blocks, np.int32), neg2d, B,
            neg2d.shape[1], int(eval_mode))

    def get_rows(self, nodes: np.ndarray):
        nodes = np.ascontiguousarray(nodes, np.int64)
        n = len(nodes)
        K = self.K
        nbr = np.zeros((n, K), np.int32)
        eid = np.full((n, K), -1, np.int64)
        tt = np.full((n, K), -1.0, np.float32)
        clock = np.zeros(n, np.float32)
        owned = np.zeros(n, np.uint8)
        if n:
            self._lib.owned_get_rows(self._h, nodes, n, nbr, eid, tt, clock,
                                     owned)
        return nbr, eid, tt, clock, owned.astype(bool)

    def get_mail(self, nodes: np.ndarray):
        nodes = np.ascontiguousarray(nodes, np.int64)
        n = len(nodes)
        ptr = np.zeros(n, np.int64)
        owned = np.zeros(n, np.uint8)
        if n:
            self._lib.owned_get_mail(self._h, nodes, n, ptr, owned)
        return ptr, owned.astype(bool)

    def reset_cache(self) -> None:
        self._lib.owned_reset_cache(self._h)

    def load_from_serial(self, packer) -> None:
        """Take the owned rows of a serial packer's whole state."""
        self._lib.owned_load_from_serial(
            self._h,
            np.ascontiguousarray(packer.cache_nbr, np.int32),
            np.ascontiguousarray(packer.cache_eid, np.int64),
            np.ascontiguousarray(packer.cache_t, np.float32),
            np.ascontiguousarray(packer.clock, np.float32),
            np.ascontiguousarray(packer.mail_ptr, np.int64))

    def _dump(self):
        n_own = self.hi - self.lo
        nbr = np.zeros((n_own, self.K), np.int32)
        eid = np.zeros((n_own, self.K), np.int64)
        tt = np.zeros((n_own, self.K), np.float32)
        clock = np.zeros(n_own, np.float32)
        ptr = np.zeros(n_own, np.int64)
        me = ctypes.c_int64(0)
        self._lib.owned_get_state(self._h, nbr, eid, tt, clock, ptr,
                                  ctypes.byref(me))
        return nbr, eid, tt, clock, ptr, int(me.value)

    @property
    def cache_nbr(self):
        return self._dump()[0]

    @property
    def cache_eid(self):
        return self._dump()[1]

    @property
    def cache_t(self):
        return self._dump()[2]

    @property
    def clock(self):
        return self._dump()[3]

    @property
    def mail_ptr(self):
        return self._dump()[4]

    @property
    def merge_entries(self):
        return self._dump()[5]


def gather_rows(owners: Sequence, nodes: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                           int]:
    """The pack-time boundary gather: cache rows and clocks of any node
    set from their owners.  Returns (cache_nbr (n, K), cache_eid, cache_t,
    clock (n,), bytes), ``bytes`` what an exchange between processes
    would ship (16 B a cache entry, 4 B a clock, for every gathered
    row)."""
    nodes = np.asarray(nodes, np.int64)
    n = len(nodes)
    K = owners[0].K
    out_nbr = np.zeros((n, K), np.int32)
    out_eid = np.full((n, K), -1, np.int64)
    out_t = np.full((n, K), -1.0, np.float32)
    out_clock = np.zeros(n, np.float32)
    wire_bytes = 0
    for ow in owners:
        nbr, eid, tt, clock, m = ow.get_rows(nodes)
        if not m.any():
            continue
        out_nbr[m] = nbr[m]
        out_eid[m] = eid[m]
        out_t[m] = tt[m]
        out_clock[m] = clock[m]
        wire_bytes += int(m.sum()) * (K * 16 + 4)
    return out_nbr, out_eid, out_t, out_clock, wire_bytes


def gather_mail(owners: Sequence, nodes: np.ndarray):
    """Ring pointers of any node set from their owners, and the bytes
    (8 a node) an exchange would ship."""
    nodes = np.asarray(nodes, np.int64)
    out = np.zeros(len(nodes), np.int64)
    nbytes = 0
    for ow in owners:
        ptr, m = ow.get_mail(nodes)
        out[m] = ptr[m]
        nbytes += int(m.sum()) * 8
    return out, nbytes


def pack_with_gathered_state(scratch, owners: Sequence, src, dst, t,
                             ev_idx, blocks, neg, eval_mode: bool = False):
    """Pack ONE batch against the owners' state.

    ``scratch`` is a full-N packer in a fresh packer's state (empty cache,
    zero clocks and pointers), borrowed: the rows the pack reads are
    filled with gathered rows, the batch is packed with ``insert=False``
    (the owners' ``apply_batch`` advances the state) and the dirtied rows
    are cleared again, O(gathered rows) a pack.  The pack reads the cache
    rows and clocks of the batch's roots (src, dst and negatives), the
    clocks of the roots' cache neighbours (the Δt), and the ring pointers
    of the write nodes (src and dst, roots already).  Returns (wire,
    intra_width, bytes of the three gathers)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    roots = np.unique(np.concatenate(
        [src.astype(np.int64), dst.astype(np.int64),
         np.asarray(neg).astype(np.int64).ravel()]))
    # 1: root cache rows and clocks
    nbr, eid, ct, clock_r, b1 = gather_rows(owners, roots)
    # 2: the cache neighbours' clocks, the roots' own excluded
    nbr_nodes = np.unique(nbr[eid >= 0].astype(np.int64))
    extra = np.setdiff1d(nbr_nodes, roots, assume_unique=True)
    _, _, _, clock_n, _ = gather_rows(owners, extra)
    b2 = len(extra) * 4          # a clock-only round ships 4 B a node
    # 3: the write nodes' ring pointers
    wr_nodes = np.unique(np.concatenate([src, dst]).astype(np.int64))
    mail, b3 = gather_mail(owners, wr_nodes)

    scratch.set_rows(roots, nbr, eid, ct, clock_r)
    scratch.set_clock_rows(extra, clock_n)
    scratch.set_mail_rows(wr_nodes, mail)
    try:
        wire, iw = scratch.pack_wire(src, dst, t, ev_idx, blocks, neg,
                                     eval_mode=eval_mode, insert=False)
    finally:
        dirty = np.unique(np.concatenate([roots, extra, wr_nodes]))
        scratch.clear_rows(dirty, zero_all_clocks=eval_mode)
    return wire, iw, b1 + b2 + b3


def restore_serial_from_owners(packer, owners: Sequence) -> None:
    """Rebuild a serial packer's whole state from the owners (one O(N)
    gather, once an epoch).  ``cur_e_id`` is max(cache e_id) + 1: the
    latest insert always stands in its endpoints' top-K rows."""
    N = owners[-1].hi
    nodes = np.arange(N, dtype=np.int64)
    nbr, eid, ct, clock, _ = gather_rows(owners, nodes)
    mail, _ = gather_mail(owners, nodes)
    cur = int(eid.max()) + 1 if eid.size and eid.max() >= 0 else 0
    if hasattr(packer, "load_state"):            # native packer
        packer.load_state(nbr, eid, ct, clock, cur, mail)
    else:
        packer.cache_nbr[:] = nbr
        packer.cache_eid[:] = eid
        packer.cache_t[:] = ct
        packer.clock[:] = clock
        packer.mail_ptr[:] = mail
        packer.cur_e_id = cur


class DistributedOwnerExchange:
    """The boundary-row gathers across processes (tgb_tgn_dgl_tpu
    parallel/owned_state.py:471-566): each process holds ONE owner, and
    ``get_rows``/``get_mail`` of any node set resolve in two rounds over
    the injected ``allgather`` (this process's int64 payload -> every
    process's, in rank order):

      round A: every process all-gathers its request node list;
      round B: every process answers every request with the rows it owns
      (request positions and row payload), all-gathered back; a process
      keeps the segments addressed to it.

    It has a local owner's ``get_rows``/``get_mail`` surface and covers
    every node, so ``[exchange]`` stands in for the owners list of
    ``gather_rows`` / ``gather_mail`` / ``pack_with_gathered_state``.
    Every process must make the same sequence of gathers (one
    ``pack_with_gathered_state`` a process a super-batch: three).  Numpy
    only; the payload spends 8 bytes an element."""

    def __init__(self, owner, host: int, n_hosts: int, allgather):
        self.owner = owner
        self.host = host
        self.n_hosts = n_hosts
        self.allgather = allgather
        self.K = owner.K
        self.S = owner.S
        self.lo = 0             # stands for every node the processes own
        self.hi = owner.N

    def _resolve(self, nodes, fields_fn, width: int):
        """The two rounds.  ``fields_fn(req_nodes)`` gives the local
        owner's (payload (n, width) int64, owned mask); returns the
        assembled (n, width) matrix and the mask of the rows found."""
        nodes = np.asarray(nodes, np.int64)
        parts = []
        for h, req in enumerate(self.allgather(nodes)):
            data, owned = fields_fn(np.asarray(req, np.int64))
            pos = np.nonzero(owned)[0].astype(np.int64)
            parts.append(np.concatenate(
                [np.asarray([h, len(pos)], np.int64), pos,
                 data[pos].reshape(-1)]))
        out = np.zeros((len(nodes), width), np.int64)
        mask = np.zeros(len(nodes), bool)
        for payload in self.allgather(np.concatenate(parts)):
            payload = np.asarray(payload, np.int64)
            i = 0
            while i < len(payload):
                dest, npos = int(payload[i]), int(payload[i + 1])
                pos = payload[i + 2:i + 2 + npos]
                i += 2 + npos
                data = payload[i:i + npos * width].reshape(npos, width)
                i += npos * width
                if dest == self.host and npos:
                    out[pos] = data
                    mask[pos] = True
        return out, mask

    def get_rows(self, nodes):
        K = self.K

        def fields(req):
            nbr, eid, t, clock, owned = self.owner.get_rows(req)
            return np.concatenate(
                [nbr.astype(np.int64), eid,
                 t.view(np.uint32).astype(np.int64),
                 clock.view(np.uint32).astype(np.int64)[:, None]],
                axis=1), owned

        out, mask = self._resolve(nodes, fields, 3 * K + 1)
        n = len(out)
        nbr = out[:, :K].astype(np.int32)
        eid = np.where(mask[:, None], out[:, K:2 * K], -1)
        t = out[:, 2 * K:3 * K].astype(np.uint32).view(np.float32)
        t = np.where(mask[:, None], t.reshape(n, K), -1.0).astype(np.float32)
        clock = out[:, 3 * K].astype(np.uint32).view(np.float32)
        clock = np.where(mask, clock.reshape(n), 0.0).astype(np.float32)
        return nbr, eid, t, clock, mask

    def get_mail(self, nodes):
        def fields(req):
            ptr, owned = self.owner.get_mail(req)
            return ptr[:, None], owned

        out, mask = self._resolve(nodes, fields, 1)
        return out[:, 0], mask
