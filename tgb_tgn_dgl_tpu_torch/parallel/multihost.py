"""Multi-host temporal-stream parallelism on one device: edge-range
partitioning with a super-batch event exchange (the port's counterpart of
tgb_tgn_dgl_tpu/parallel/multihost.py, without its multi-process pieces).

Protocol ("super-batch exchange"):

  * The stream is cut into super-batches of ``n_hosts * batch_size``
    events; host h takes the h-th contiguous batch-sized range.
  * Each host packs its range as one batch against the stream state at
    the super-batch's start plus its own range's updates: it does not see
    its siblings' events of the same super-batch (bounded staleness).
  * At the boundary every host gathers the super-batch's raw events and
    train negatives (state is never shipped: the packer state is a pure
    function of the event stream) and replays them in stream order: cache
    inserts of the remote ranges (last-K by e_id over distinct e_ids
    commutes), the clock writes of every range in range order, and the
    mail ring pointers of the remote ranges.  Every host's packer state is
    then the serial packer's, exactly.
  * The ranges' wires compose into one wire (``concat_offset_wires``), and
    one composed step trains on the whole super-batch.

Here the hosts are ranges of one process on one device: the engine
(parallel/mh_engine.py) gathers with a local closure.  Across processes
(torch.distributed): ``init_distributed`` joins the process group,
``multihost_allgather`` is the exchange's ragged all-gather, and
``make_process_global_wire`` assembles the super-batch's wire from each
process's range (owned_state.py::DistributedOwnerExchange is the owned
exchange across processes).

The composed steps take one Adam step over the n·B events of a
super-batch, where a serial engine takes n: that is the only departure
from serial training, and it is the protocol's (data-parallel large-step
semantics).  The memory state chain stays serial: each range commits
before the next applies its mail.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.dependency import get_block
from ..models.factory import arch_embed, arch_predict
from ..models.memory import apply_mail, commit
from ..models.tgnn import bce_loss
from ..models.variants import dyrep_messages, eager_apply_mail, eager_commit
from ..ops.wire import expand_wire


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo") -> int:
    """Join the process group of ``num_processes`` processes as
    ``process_id`` (a no-op for one process, as JAX's is); returns this
    process's rank.  ``coordinator_address`` is an init URL
    (``tcp://host:port``, ``file://path``, ``env://``); a bare
    ``host:port`` means tcp."""
    if not num_processes or num_processes == 1:
        return 0
    url = coordinator_address or "env://"
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def multihost_allgather(payload: np.ndarray, device="cpu"
                        ) -> Sequence[np.ndarray]:
    """Every process's 1-D int64 ``payload``, in rank order, over the
    process group (lengths first, then payloads padded to the longest,
    as JAX's at tgb_tgn_dgl_tpu parallel/multihost.py:203-218).  The
    payloads cross on ``device``: the CPU for gloo, a GPU for NCCL."""
    payload = np.asarray(payload, np.int64)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [payload]
    n = dist.get_world_size()
    mine = torch.tensor([len(payload)], dtype=torch.int64, device=device)
    lens = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(lens, mine)
    lens = [int(x) for x in lens]
    local = torch.zeros(max(lens), dtype=torch.int64, device=device)
    local[:len(payload)] = torch.from_numpy(payload)
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local)
    return [p[:k].cpu().numpy() for p, k in zip(parts, lens)]


def make_process_global_wire(mesh, wire, stacked: bool = False):
    """The super-batch's global wire on every rank from each rank's local
    one: each field of this rank's (offset, aligned) wire all-gathered
    over the mesh's dp axis along dim 0 (dim 1 when ``stacked``), in rank
    order; numpy fields come back as numpy, tensors as tensors (JAX
    ``make_array_from_process_local_data``, :605-622)."""
    def put(a):
        if a is None:
            return None
        t = torch.as_tensor(a)
        if stacked:
            t = mesh.all_gather(t.movedim(1, 0), "dp").movedim(0, 1)
        else:
            t = mesh.all_gather(t, "dp")
        return t.numpy() if isinstance(a, np.ndarray) else t

    return type(wire)(*(put(a) for a in wire))


@dataclass(frozen=True)
class EdgeRange:
    """Host h's contiguous slice of one super-batch (split-row offsets)."""
    lo: int
    hi: int
    host: int


def partition_super_batch(lo: int, hi: int, n_hosts: int,
                          batch_size: int) -> List[EdgeRange]:
    """Cut super-batch rows [lo, hi) into up to n_hosts contiguous
    batch-sized ranges; earlier hosts take earlier events.  The tail
    super-batch may leave trailing hosts empty (hi == lo)."""
    out, cur = [], lo
    for h in range(n_hosts):
        nxt = min(cur + batch_size, hi)
        out.append(EdgeRange(cur, nxt, h))
        cur = nxt
    if cur != hi:
        raise ValueError(f"super-batch [{lo},{hi}) larger than "
                         f"{n_hosts}x{batch_size}")
    return out


def _encode(src, dst, t, ev_idx, neg) -> np.ndarray:
    """One range's events as the exchange's int64 payload: [B, M], then
    src, dst, event rows, the float64 bits of t and the (B, M) negatives."""
    src = np.asarray(src, np.int64)
    if len(src) == 0:
        return np.asarray([0, 1], np.int64)
    neg2d = np.asarray(neg, np.int64).reshape(len(src), -1)
    head = np.asarray([len(src), neg2d.shape[1]], np.int64)
    return np.concatenate([
        head, src, np.asarray(dst, np.int64),
        np.asarray(ev_idx, np.int64),
        np.asarray(t, np.float64).view(np.int64),
        neg2d.ravel()])


def _decode(buf):
    """(src, dst, t, ev_idx, neg (B, M)) of an ``_encode`` payload."""
    buf = np.asarray(buf)
    B, M = int(buf[0]), int(buf[1])
    o = 2
    src = buf[o:o + B].astype(np.int32); o += B
    dst = buf[o:o + B].astype(np.int32); o += B
    ev_idx = buf[o:o + B]; o += B
    t = buf[o:o + B].view(np.float64).astype(np.float32); o += B
    neg = buf[o:o + B * M].reshape(B, M).astype(np.int32)
    return src, dst, t, ev_idx, neg


class SuperBatchExchanger:
    """Restores serial-stream packer state at each super-batch boundary.

    ``allgather`` is injected: it maps this host's payload to every
    host's, in host order (one process passes a closure over all the
    payloads).  ``host=-1`` treats every range as remote: the engine
    restores its packer to the super-batch's start and replays it all."""

    def __init__(self, packer, host: int, n_hosts: int, allgather=None):
        self.packer = packer
        self.host = host
        self.n_hosts = n_hosts
        self.allgather = allgather or (lambda payload: [payload])

    def exchange(self, src, dst, t, ev_idx, neg) -> None:
        """Called once per super-batch with THIS host's consumed range
        (already packed and inserted locally); empty arrays for an idle
        tail host.

        Clocks and ring pointers go through a read-modify-write-back
        cycle: the native packer's ``clock``/``mail_ptr`` return copies,
        so changing them in place would be lost."""
        parts = self.allgather(_encode(src, dst, t, ev_idx, neg))
        if len(parts) != self.n_hosts:
            raise ValueError(f"expected {self.n_hosts} ranges, got "
                             f"{len(parts)}")
        decoded = [_decode(p) for p in parts]
        # 1. cache inserts of the remote ranges (order-free)
        for h, (r_src, r_dst, r_t, r_idx, _r_neg) in enumerate(decoded):
            if h == self.host or len(r_src) == 0:
                continue
            self.packer.insert(r_src, r_dst, r_t,
                               e_id=np.asarray(r_idx, np.int64))
        # 2. ring advance (remote) and clock replay (every range, in
        #    stream order: the own range's idempotent re-write restores the
        #    serial order) on copies, then written back
        clock = np.array(self.packer.clock, np.float32)
        mail_ptr = np.array(self.packer.mail_ptr, np.int64)
        for h, (r_src, r_dst, _r_t, _r_idx, _r_neg) in enumerate(decoded):
            if h != self.host and len(r_src):
                self._advance_mail(mail_ptr, r_src, r_dst)
        for r_src, r_dst, r_t, _r_idx, r_neg in decoded:
            if len(r_src):
                self._replay_clocks(clock, r_src, r_dst, r_t, r_neg)
        self._write_state(clock, mail_ptr)

    def _write_state(self, clock, mail_ptr) -> None:
        p = self.packer
        if hasattr(p, "load_state"):          # native packer
            p.load_state(p.cache_nbr, p.cache_eid, p.cache_t, clock,
                         p.cur_e_id, mail_ptr)
        else:                                 # numpy packer
            p.clock = clock
            p.mail_ptr = mail_ptr

    def _advance_mail(self, mail_ptr, src, dst) -> None:
        S = self.packer.cfg.mailbox_size
        nodes = np.concatenate([src, dst]).astype(np.int64)
        uniq, counts = np.unique(nodes, return_counts=True)
        kept = np.minimum(counts, S)
        mail_ptr[uniq] = (mail_ptr[uniq] + kept) % S

    def _replay_clocks(self, clock, src, dst, t, neg2d) -> None:
        """Re-derive the serial clock: per dependency block (recomputed;
        the range is one batch, so get_block gives what its host packed
        with), write negatives, then dst, then src."""
        blocks = get_block(src, dst)
        M = neg2d.shape[1]
        for i in range(int(blocks.max()) + 1):
            sel = np.nonzero(blocks == i)[0]
            ti = t[sel]
            clock[neg2d[sel].ravel()] = np.repeat(ti, M)
            clock[dst[sel]] = ti
            clock[src[sel]] = ti


def replan_mail_slots(srcs, dsts, mail_ptr0, S: int, B: int):
    """Re-plan the mailbox ring slots of a super-batch at compose time.

    Each host planned its range against the super-batch's start pointers,
    so ranges h > 0 carry plans a serial packer would not emit.  From the
    ranges' events (stream order) and the start pointers ``mail_ptr0``,
    this recomputes the serial per-batch plans: per batch, per node, the
    last min(count, S) writes at slots (ptr + 0..kept) % S, ptr advanced
    by kept, the pointers evolving across ranges.

    Returns (plans, mail_ptr_end): plans[h] is a (2B,) int64
    identity-indexed slot array (entry 2i = event i's src write, 2i+1 its
    dst write; -1 = dropped), mail_ptr_end the serial end pointers.
    Writes to one (node, slot) from different ranges are not
    deduplicated: the composed memory step commits range by range, so a
    later range's write overwrites an earlier one's as serial commits do."""
    n = len(srcs)
    ptr = np.asarray(mail_ptr0, np.int64).copy()
    plans = [np.full(2 * B, -1, np.int64) for _ in range(n)]
    for h in range(n):
        src = np.asarray(srcs[h], np.int64)
        dst = np.asarray(dsts[h], np.int64)
        braw = len(src)
        if braw == 0:
            continue
        # grouped cumcount: writes sorted node-major in stream order;
        # within a node's run of length c, entry j is kept iff
        # j >= c - min(c, S), at ring slot (ptr[node] + j - (c - kept)) % S
        wnode = np.empty(2 * braw, np.int64)
        wnode[0::2], wnode[1::2] = src, dst
        posw = np.arange(2 * braw)
        order = np.lexsort((posw, wnode))
        sn = wnode[order]
        runs, starts, counts = np.unique(sn, return_index=True,
                                         return_counts=True)
        kept = np.minimum(counts, S)
        j = posw - np.repeat(starts, counts)
        drop = np.repeat(counts - kept, counts)
        slot = (np.repeat(ptr[runs], counts) + j - drop) % S
        plans[h][order] = np.where(j >= drop, slot, -1)
        ptr[runs] = (ptr[runs] + kept) % S
    return plans, ptr


def apply_mail_plan(wire, plan, num_nodes: int):
    """A WirePack with its mailbox write plan rewritten from an
    identity-indexed slot array (one range of ``replan_mail_slots``):
    dropped entries point at the trash row ``num_nodes`` with neutral
    payloads, as the packer's own invalid entries do."""
    plan = np.asarray(plan, np.int64)
    W = plan.shape[0]
    B = W // 2
    valid = plan >= 0
    node = np.empty(W, np.int64)
    node[0::2] = np.asarray(wire.ev_src, np.int64)[:B]
    node[1::2] = np.asarray(wire.ev_dst, np.int64)[:B]
    partner = np.empty(W, np.int64)
    partner[0::2] = np.asarray(wire.ev_dst, np.int64)[:B]
    partner[1::2] = np.asarray(wire.ev_src, np.int64)[:B]
    t2 = np.repeat(np.asarray(wire.ev_t, np.float32)[:B], 2)
    eid2 = np.repeat(np.asarray(wire.ev_idx, np.int32)[:B], 2)
    return wire._replace(
        mw_node=np.where(valid, node, num_nodes).astype(np.int32),
        mw_slot=np.where(valid, plan, 0).astype(np.int32),
        mw_partner=np.where(valid, partner, 0).astype(np.int32),
        mw_t=np.where(valid, t2, 0.0).astype(np.float32),
        mw_eid=np.where(valid, eid2, 0).astype(np.int32),
    )


def offset_wire_for_host(wire, host: int, n_hosts: int):
    """Rebase host ``host``'s WirePack so that the n_hosts wires
    concatenate into one valid wire of the super-batch:

      * root-slot indices (ev_src/pos/neg_slot) shift by host·R;
      * uniq-table indices (root_loc, cache_loc, ia_loc) shift by host·Ub
        (a padded loc keeps pointing at its host's trash entry, whose
        value is num_nodes, so the expansion stays safe);
      * intra-COO padding rows (ia_row == R, the scatter's trash row) go
        to the composed trash row n_hosts·R: a plain shift would alias
        the next host's row 0.

    The composed wire is n_hosts batches as ONE batch of n_hosts·B events
    whose dependency grids are disjoint row ranges.  Its mail plan is only
    valid with the frozen memory unless the ranges were re-planned
    (``concat_offset_wires(mail_plans=...)``)."""
    R = wire.root_loc.shape[0]
    Ub = wire.uniq_nid.shape[0]
    h = host

    def slot(a):
        return (np.asarray(a, np.int64) + h * R).astype(np.int32)

    def loc(a):
        return (np.asarray(a, np.int64) + h * Ub).astype(np.int32)

    ia_row = np.asarray(wire.ia_row, np.int64)
    ia_row = np.where(ia_row == R, n_hosts * R, ia_row + h * R)
    return wire._replace(
        ev_src_slot=slot(wire.ev_src_slot),
        ev_pos_slot=slot(wire.ev_pos_slot),
        ev_neg_slot=slot(wire.ev_neg_slot),
        root_loc=loc(wire.root_loc),
        cache_loc=loc(wire.cache_loc),
        ia_loc=loc(wire.ia_loc),
        ia_row=ia_row.astype(np.int32),
    )


def pad_wire_ei(wire, Ei: int):
    """Pad a WirePack's intra-COO fields to the length ``Ei`` (trash fill:
    ia_row = R scatters into the expansion's trash row)."""
    cur = wire.ia_row.shape[0]
    if cur == Ei:
        return wire
    if cur > Ei:
        raise ValueError(f"intra COO of {cur} entries over {Ei}")
    R = wire.root_loc.shape[0]
    pad = Ei - cur

    def ext(a, fill):
        a = np.asarray(a)
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    kw = dict(ia_row=ext(wire.ia_row, R), ia_col=ext(wire.ia_col, 0),
              ia_loc=ext(wire.ia_loc, 0), ia_feat=ext(wire.ia_feat, 0),
              ia_dt=ext(wire.ia_dt, 0.0))
    if wire.ia_rslot is not None:
        kw["ia_rslot"] = ext(wire.ia_rslot, -1)
    return wire._replace(**kw)


def align_wires(wires):
    """Equalise the nnz-dependent Ei buckets of the hosts' wires."""
    Ei = max(w.ia_row.shape[0] for w in wires)
    return [pad_wire_ei(w, Ei) for w in wires]


# the intra-COO fields, whose length (Ei) follows each range's nnz
_EI_FIELDS = frozenset({"ia_row", "ia_col", "ia_loc", "ia_feat", "ia_dt",
                        "ia_rslot"})


def concat_offset_wires(wires, mail_plans=None, num_nodes=None):
    """Compose the hosts' WirePacks into the super-batch's wire.

    ``mail_plans`` (``replan_mail_slots``) rewrites each range's mailbox
    write plan to the serial slots before composing; the memory's composed
    step needs it (without it the plan is only valid with the frozen
    memory).  Every wire must be in the same shape buckets apart from Ei:
    the offsets are multiples of wire 0's sizes, so a larger sibling would
    compose a corrupt wire (``Engine.warm_buckets`` makes them equal)."""
    n = len(wires)
    for w in wires[1:]:
        for f in wires[0]._fields:
            if f in _EI_FIELDS:
                continue
            a, b = getattr(wires[0], f), getattr(w, f)
            if (a is None) != (b is None) or (
                    a is not None and np.shape(a) != np.shape(b)):
                raise ValueError(
                    f"compose shape mismatch on '{f}': {np.shape(a)} vs "
                    f"{np.shape(b)}; warm the shape buckets "
                    f"(Engine.warm_buckets) before composing")
    if mail_plans is not None:
        if num_nodes is None:
            raise ValueError("mail_plans need num_nodes")
        wires = [apply_mail_plan(w, pl, num_nodes)
                 for w, pl in zip(wires, mail_plans)]
    wires = align_wires(wires)
    off = [offset_wire_for_host(w, h, n) for h, w in enumerate(wires)]
    cls = type(off[0])
    return cls(*[(None if getattr(off[0], f) is None
                  else np.concatenate([np.asarray(getattr(w, f))
                                       for w in off]))
                 for f in cls._fields])


def build_composed_memory_step(model, model_cfg, mem_cfg, optimizer,
                               K: int, IW: int, N: int, n_ranges: int,
                               arch: str = "transformer_attention",
                               generator=None):
    """The composed super-batch step with the mailbox memory
    (tgb_tgn_dgl_tpu parallel/multihost.py:428-511).

    The memory's state chain (apply_mail → commit per batch) does not read
    the model's forward: the lazy mail is built from memory, mailbox and
    raw features alone.  So the step runs the chain over the n ranges in
    stream order (range h applies the mail that ranges < h committed, as a
    serial engine's batch h does), then ONE embedding over all ranges'
    memory rows, the BCE over all n·B events, one backward and one Adam
    step.  Each commit writes the state in place, before the backward:
    the state never requires grad, and what autograd keeps of range h are
    gathered copies, so no saved tensor is overwritten; the rows are
    committed detached (the serial engine's one-step truncated BPTT).
    ``arch``: 'transformer_attention' (TGN) or 'identity' (JODIE); DyRep
    takes ``build_composed_dyrep_step``.  Dropout masks come from
    ``generator`` in the order of the one forward.

    The composed wire's write plans must be serial (``replan_mail_slots``
    + ``concat_offset_wires(mail_plans=...)``).  Returns
    ``step(mem_state, feats, wire) -> (mem_state, loss, pos, neg)`` on a
    device WirePack, the outputs detached."""
    n = n_ranges

    def step(mem_state, feats, wire):
        pack = expand_wire(wire, K, IW, N)
        Ub = pack.uniq_nid.shape[0] // n
        W1 = pack.mw_node.shape[0] // n
        optimizer.zero_grad(set_to_none=True)
        rows, lus = [], []
        for h in range(n):
            u_h = pack.uniq_nid[h * Ub:(h + 1) * Ub]
            r_h, l_h = apply_mail(model.memory, mem_cfg, mem_state, u_h,
                                  feats)
            sl = slice(h * W1, (h + 1) * W1)
            mem_state = commit(mem_cfg, mem_state, u_h, r_h.detach(),
                               l_h.detach(), pack.mw_node[sl],
                               pack.mw_slot[sl], pack.mw_partner[sl],
                               pack.mw_t[sl], pack.mw_eid[sl])
            rows.append(r_h)
            lus.append(l_h)
        embed = arch_embed(model, arch, model_cfg, torch.cat(rows),
                           torch.cat(lus), feats, pack, train=True,
                           generator=generator, local=True)
        pos, neg = arch_predict(model, embed, pack)
        loss = bce_loss(pos, neg, pack.ev_valid)
        loss.backward()
        optimizer.step()
        return mem_state, loss.detach(), pos.detach(), neg.detach()

    return step


def build_composed_dyrep_step(model, model_cfg, mem_cfg, optimizer,
                              K: int, IW: int, N: int, n_ranges: int,
                              generator=None):
    """The composed super-batch step of DyRep's eager memory
    (tgb_tgn_dgl_tpu parallel/multihost.py:514-602).

    DyRep's mail holds the event partner's embedding, so range h's commit
    needs range h's forward and range h+1 applies that mail: the whole
    per-range pipeline chains in stream order.  Over the stacked per-range
    wires (leading axis n, each range expanded on its own), range by
    range: ``eager_apply_mail`` → embed → predict → BCE → the mail from the
    detached embedding and the model's time encoder (not yet stepped, as
    in the serial engine) → ``eager_commit`` in place, before the
    backward (no tensor autograd keeps is a view of the state).  Then one
    backward of the loss summed over the ranges over n, and one Adam
    step.  Dropout masks come from ``generator`` in the order of the n
    forwards.

    Mail slots must be re-planned per range before stacking
    (``replan_mail_slots`` + ``apply_mail_plan``).  Returns
    ``step(mem_state, feats, wires) -> (mem_state, loss, pos, neg)`` on a
    device WirePack of stacked fields, pos and neg concatenated over the
    ranges, the outputs detached."""
    n = n_ranges

    def step(mem_state, feats, wires):
        optimizer.zero_grad(set_to_none=True)
        loss_sum = 0.0
        pos_all, neg_all = [], []
        for h in range(n):
            wire = type(wires)(*(None if a is None else a[h]
                                 for a in wires))
            pack = expand_wire(wire, K, IW, N)
            mem_rows, lu_rows = eager_apply_mail(model.memory, mem_cfg,
                                                 mem_state, pack.uniq_nid)
            embed = arch_embed(model, "dyrep", model_cfg, mem_rows, lu_rows,
                               feats, pack, train=True, generator=generator,
                               local=True)
            pos, neg = arch_predict(model, embed, pack)
            loss_sum = loss_sum + bce_loss(pos, neg, pack.ev_valid)
            mem_rows, lu_rows = mem_rows.detach(), lu_rows.detach()
            mail = dyrep_messages(mem_cfg, embed.detach(), pack, feats,
                                  model.time, mem_rows, lu_rows)
            mem_state = eager_commit(mem_cfg, mem_state, pack.uniq_nid,
                                     mem_rows, lu_rows, pack.mw_node,
                                     pack.mw_slot, mail, pack.mw_t,
                                     pack.mw_eid)
            pos_all.append(pos.detach())
            neg_all.append(neg.detach())
        loss = loss_sum / n
        loss.backward()
        optimizer.step()
        return (mem_state, loss.detach(), torch.cat(pos_all),
                torch.cat(neg_all))

    return step
