"""NativeLeanPacker: the host side of device-cache mode (ops/lean_wire.py),
the port's counterpart of tgb_tgn_dgl_tpu/data/lean_packer.py.

It emits a ``LeanWire`` per batch through ``packer_pack_fill_lean`` of the
port's csrc/packer.cpp: root sets, slot maps, the intra-batch COO, the
mailbox write plan and the resolved per-(node, block) clock writes, all
functions of the batch's events and negatives.  Unlike NativeStreamPacker
it reads no neighbor cache and no clock: that state lives on the device
(``StreamDeviceState``), so the host gathers nothing of O(N) size and the
wire carries no (R, K) cache grids.  Its only stream state is the mailbox
ring-pointer vector, kept in the C++ handle.

The library is built at the first packer (ops/_build.py::host_library);
a failed build raises.  There is no numpy ``LeanPacker`` in the port and
no factory that falls back to one: the tests hold this packer against the
JAX package's ``LeanPacker`` and ``NativeLeanPacker``.

Clock-write resolution (reference model_utils.py:68-83): within block i
the reference assigns clock[neg] = t, clock[dst] = t, clock[src] = t over
the block's events in order, so the value left per (node, block) is the
write with the largest (phase, event position), phase neg < dst < src.
Eval mode first wipes every clock to the block's max time (:78-79) and
writes only dst and src: the wipe values travel in the wire (``wipe_t``).
"""
from __future__ import annotations

import numpy as np

from .native_packer import PackerHandle
from .packer import PackerConfig, _bucket_pow2


class NativeLeanPacker(PackerHandle):
    """The lean emitter over the port's packer library, with the sticky
    shape buckets (``bucket_state``/``load_bucket_state``) that
    ``NativeStreamPacker`` keeps.  ``reset_cache`` (train-epoch start)
    puts the ring pointers back to 0; the device resets its cache
    (``reset_stream_cache``)."""

    def __init__(self, num_nodes: int, cfg: PackerConfig):
        if cfg.strategy != "recent" or cfg.layers != 1:
            raise NotImplementedError(
                f"device-cache mode runs the 'recent' strategy at one layer "
                f"(got strategy={cfg.strategy!r}, layers={cfg.layers})")
        super().__init__(num_nodes, cfg)

    @property
    def mail_ptr(self) -> np.ndarray:
        """The (N,) int64 mailbox ring pointers."""
        return self._get_state()[5]

    @mail_ptr.setter
    def mail_ptr(self, value) -> None:
        nbr, eid, t, clock, cur, _ = self._get_state()
        self._lib.packer_set_state(self._h, nbr, eid, t, clock,
                                   np.ascontiguousarray(value, np.int64),
                                   int(cur))

    def snapshot(self):
        """(mail_ptr,): the packer's whole stream state."""
        return (self.mail_ptr,)

    def restore(self, snap) -> None:
        self.mail_ptr = snap[0]

    # -------------------------------------------------------------- pack
    def pack_wire(self, src, dst, t, ev_idx, blocks, neg,
                  eval_mode: bool = False, insert: bool = True,
                  write_mail: bool = True):
        """One batch as a LeanWire of numpy arrays; returns (wire,
        intra_width).  ``insert`` advances the ring pointers (the device
        state advances in ``advance_stream``), ``write_mail`` fills the
        write plan; a non-last eval chunk passes both False."""
        from ..ops.lean_wire import LeanWire

        cfg = self.cfg
        B = cfg.batch_size
        k = int(np.max(blocks)) + 1 if len(src) else 0
        sizes, M, skey = self._begin(src, dst, t, ev_idx, blocks, neg,
                                     eval_mode)
        total_roots, p_exact, nnz = sizes[0], sizes[1], sizes[3]
        P = self._intra_width(skey, p_exact)
        R = self._sticky_bucket(skey, "R", _bucket_pow2(max(total_roots, 1),
                                                        cfg.root_bucket_lo))
        Ei = self._sticky_bucket(skey, "Ei",
                                 _bucket_pow2(max(nnz, 1), lo=2 * B))
        # one resolved write per (participant, block) at most: a bound
        # fixed per (M, eval_mode)
        Q = _bucket_pow2(max((2 + (0 if eval_mode else M)) * B, 1), lo=B)
        Kb = self._sticky_bucket(skey, "Kb", _bucket_pow2(max(k, 1), lo=16))
        W = 2 * B
        i32 = np.int32
        ev_src, ev_dst = np.empty(B, i32), np.empty(B, i32)
        ev_t, ev_idx_out = np.empty(B, np.float32), np.empty(B, i32)
        ev_valid = np.empty(B, np.uint8)
        ev_neg = np.empty((B, M), i32)
        ev_src_slot, ev_pos_slot = np.empty(B, i32), np.empty(B, i32)
        ev_neg_slot = np.empty((B, M), i32)
        root_nid, root_blk = np.empty(R, i32), np.empty(R, i32)
        ia_row, ia_pos, ia_side = (np.empty(Ei, i32) for _ in range(3))
        mw_node, mw_slot = np.empty(W, i32), np.empty(W, i32)
        mw_partner, mw_eid = np.empty(W, i32), np.empty(W, i32)
        mw_t = np.empty(W, np.float32)
        upd_node, upd_blk = np.empty(Q, i32), np.empty(Q, i32)
        upd_t, upd_last = np.empty(Q, np.float32), np.empty(Q, np.uint8)
        wipe_t = np.empty(Kb, np.float32)
        wipe_final = np.zeros(1, np.float32)
        self._lib.packer_pack_fill_lean(
            self._h, B, R, int(insert), int(write_mail),
            ev_src, ev_dst, ev_t, ev_idx_out, ev_valid, ev_neg,
            ev_src_slot, ev_pos_slot, ev_neg_slot,
            root_nid, root_blk,
            Ei, ia_row, ia_pos, ia_side,
            mw_node, mw_slot, mw_partner, mw_t, mw_eid,
            Q, upd_node, upd_blk, upd_t, upd_last,
            Kb, wipe_t, wipe_final)
        wire = LeanWire(
            ev_src=ev_src, ev_dst=ev_dst, ev_t=ev_t, ev_idx=ev_idx_out,
            ev_valid=ev_valid.astype(bool),
            ev_neg=ev_neg if M > 1 else ev_neg[:, 0],
            ev_src_slot=ev_src_slot, ev_pos_slot=ev_pos_slot,
            ev_neg_slot=ev_neg_slot if M > 1 else ev_neg_slot[:, 0],
            root_nid=root_nid, root_blk=root_blk,
            ia_row=ia_row, ia_pos=ia_pos, ia_side=ia_side,
            mw_node=mw_node, mw_slot=mw_slot, mw_partner=mw_partner,
            mw_t=mw_t, mw_eid=mw_eid,
            upd_node=upd_node, upd_blk=upd_blk, upd_t=upd_t,
            upd_last=upd_last.astype(bool),
            wipe_t=wipe_t, wipe_final=wipe_final.reshape(()),
        )
        return wire, P
