"""MultiHostEngine: the N-host super-batch training engine on one device
(the port's counterpart of tgb_tgn_dgl_tpu/parallel/mh_engine.py with
``mesh=None``).

Per super-batch of ``n_hosts × batch_size`` events, each host range packs
against the super-batch's start state, the mail slots are re-planned
serially (``replan_mail_slots``), the ranges' wires compose into one
wire, one composed step trains on the whole super-batch, and the exchange
gives the packer the serial state for the next super-batch.  The
composed steps:

  * frozen memory: ``build_composed_frozen_step``, one forward, backward
    and Adam step over the composed wire;
  * the mailbox memory (TGN, JODIE):
    multihost.py::build_composed_memory_step, the state chain range by
    range, then one forward over all ranges;
  * DyRep's eager memory: multihost.py::build_composed_dyrep_step over
    the stacked, not composed, per-range wires.

Two exchanges keep the stream state:

  * ``"replicated"``: the engine's packer is snapshotted, each range packs
    from the snapshot, and the packer is restored and replays the whole
    super-batch (``SuperBatchExchanger`` with ``host=-1``);
  * ``"owned"``: node-range owners (owned_state.py, native) keep the
    state, each range packs on a scratch packer filled by boundary
    gathers, the owners apply the super-batch, and at the end of the loop
    the serial packer takes its whole state back from them.  It trains
    bit-equal to ``"replicated"``.

Everything outside ``train_epoch`` (``evaluate``, ``fit``,
``warm_buckets``, the stream snapshots and the checkpoints) is
``Engine``'s: at every super-batch boundary the packer and memory state
are a serial engine's, so the single-device code runs on them.  The
epoch's tail (fewer than n_hosts × B events) trains through the inherited
single-device step, each batch packed on this thread.  All packs here are
synchronous: a job pending on the packer's thread would race the
snapshot and restore.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.native_packer import NativeStreamPacker
from ..engine.train import Engine
from ..models.tgnn import bce_loss, tgnn_forward
from ..ops.wire import expand_wire, stack_wires, wire_to_device
from ..utils.config import FrameworkConfig
from .multihost import (EdgeRange, SuperBatchExchanger, _encode, align_wires,
                        apply_mail_plan, build_composed_dyrep_step,
                        build_composed_memory_step, concat_offset_wires,
                        partition_super_batch, replan_mail_slots)
from .owned_state import (NativeNodeRangeOwnedState, gather_mail,
                          pack_with_gathered_state,
                          restore_serial_from_owners)

EXCHANGES = ("replicated", "owned")


def build_composed_frozen_step(model, model_cfg, optimizer, K: int, IW: int,
                               N: int, generator=None):
    """The composed super-batch step with the frozen all-ones memory
    (tgb_tgn_dgl_tpu parallel/mh_engine.py:47-76): one forward, backward
    and Adam step over the composed wire, no state chain.  Returns
    ``step(feats, wire) -> (loss, pos, neg)`` on a device WirePack, the
    outputs detached."""

    def step(feats, wire):
        pack = expand_wire(wire, K, IW, N)
        optimizer.zero_grad(set_to_none=True)
        pos, neg = tgnn_forward(model, model_cfg, None, feats, pack,
                                train=True, generator=generator)
        loss = bce_loss(pos, neg, pack.ev_valid)
        loss.backward()
        optimizer.step()
        return loss.detach(), pos.detach(), neg.detach()

    return step


class MultiHostEngine(Engine):
    """The N-host super-batch engine (module docstring) on one device,
    ``device=None`` meaning the GPU as for ``Engine``.

    Needs a fixed ``train.max_intra_block`` (every range's intra width is
    the cap), the host packer's WirePack (not device-cache mode), the
    'recent' strategy and one attention layer: the composition shifts no
    same-block root slots."""

    def __init__(self, data, config: FrameworkConfig, n_hosts: int,
                 exchange: str = "replicated", device=None):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}; expected one "
                             f"of {list(EXCHANGES)}")
        if config.train.max_intra_block is None:
            raise ValueError("MultiHostEngine needs a fixed "
                             "train.max_intra_block")
        if config.sampling.strategy != "recent":
            # the JAX MultiHostEngine's scratch packer has no t-CSR
            # (tgb_tgn_dgl_tpu parallel/mh_engine.py:119-120), and its
            # exchange's snapshots leave out the packer's draws
            raise ValueError("MultiHostEngine samples the 'recent' strategy "
                             "only (the JAX engine's range packs have no "
                             "t-CSR and its exchange drops the uniform "
                             "draws); use Engine for sampling.strategy "
                             "'uniform'")
        if config.train.device_cache or config.gnn.layer != 1:
            raise ValueError("MultiHostEngine composes host-packed wires "
                             "at one attention layer (no train.device_cache,"
                             " gnn.layer: 1)")
        super().__init__(data, config, device=device)
        self.n_hosts = n_hosts
        self.exchange = exchange
        K = config.sampling.num_neighbors
        IW = config.train.max_intra_block
        N = data.num_nodes
        if exchange == "owned":
            S = config.memory.mailbox_size
            self._owners = [NativeNodeRangeOwnedState(N, n_hosts, h, K, S)
                            for h in range(n_hosts)]
            # the scratch packer shares the packer's sticky table at each
            # epoch start (train_epoch): its packs land in the buckets of
            # the serial and tail packs
            self._scratch = NativeStreamPacker(N, self.packer.cfg)
        if self.use_memory and self.eager_memory:
            self._composed_step = build_composed_dyrep_step(
                self.model, self.model_cfg, self.mem_cfg, self.optimizer, K,
                IW, N, n_hosts, generator=self.generator)
        elif self.use_memory:
            self._composed_step = build_composed_memory_step(
                self.model, self.model_cfg, self.mem_cfg, self.optimizer, K,
                IW, N, n_hosts, arch=self.arch, generator=self.generator)
        else:
            self._composed_step = build_composed_frozen_step(
                self.model, self.model_cfg, self.optimizer, K, IW, N,
                generator=self.generator)

    def _range_events(self, rows_all, blocks_all, r):
        """(src, dst, t, rows, blocks, negatives) of one range, in
        ``pack_wire``'s order; draws its train negatives."""
        d = self.data
        idx = rows_all[r.lo:r.hi]
        dst = d.dst[idx]
        return (d.src[idx], dst, d.t[idx], idx, blocks_all[r.lo:r.hi],
                self.neg_sampler.sample(dst))

    def train_epoch(self, host_only: bool = False,
                    max_super_batches: Optional[int] = None
                    ) -> Dict[str, float]:
        """One multi-host epoch; returns what ``Engine.train_epoch``
        returns, the accumulator counting one entry a super-batch and one
        a tail batch.  ``host_only`` runs the host path (range packs,
        exchange, mail re-plan, composition) and nothing on the device:
        the measurement of the host work a deployment pays.
        ``max_super_batches`` caps the loop; both skip the tail (a capped
        loop leaves the stream mid-epoch).

        ``last_epoch_trace``: ``pack_s`` (range packs and tail packs),
        ``exchange_s`` (the replicated snapshot, restore and replay, or
        the owners' gathers, applies and hand-back), ``replan_s``,
        ``stack_s`` (composition), ``disp_s`` (the wire's copy to the
        device and the steps), ``host_s`` (the host work a host pays: its
        range's share of the range packs, the tail packs, exchange, replan
        and composition), ``batches`` and ``super_batches``."""
        if not self._warmed:
            # every range in the same shape buckets: the composition needs
            # it (concat_offset_wires)
            self.warm_buckets()
            self._warmed = True
        d = self.data
        self.packer.reset_cache()
        owned = self.exchange == "owned"
        if owned:
            # the owners take the serial state (clocks persist across
            # epochs; the tail and eval advanced the packer)
            for ow in self._owners:
                ow.reset_cache()
                ow.load_from_serial(self.packer)
            # load_bucket_state replaces the packer's table object
            self._scratch._sticky = self.packer._sticky
        if self.use_memory:
            self.mem_state = self._fresh_memory_state()
        rows_all = self._rows["train"]
        blocks_all = self.blocks_for("train")
        B = self.config.train.batch_size
        n = self.n_hosts
        sb = n * B
        n_full = (len(rows_all) // sb) * sb
        acc = torch.zeros(4, dtype=torch.float32, device=self.device)
        valid = torch.ones(sb, dtype=torch.bool, device=self.device)
        total = 0
        tm = {"pack": 0.0, "pack_tail": 0.0, "disp": 0.0, "stack": 0.0,
              "exchange": 0.0, "replan": 0.0}
        t0_epoch = time.perf_counter()
        n_sb = 0
        for lo in range(0, n_full, sb):
            if max_super_batches is not None and n_sb >= max_super_batches:
                break
            n_sb += 1
            ranges = partition_super_batch(lo, lo + sb, n, B)
            batches, wires = [], []
            if owned:
                for r in ranges:
                    ev = self._range_events(rows_all, blocks_all, r)
                    batches.append(ev)
                    # host r.host's view: the owners' state at the
                    # super-batch's start, through boundary gathers
                    t0 = time.perf_counter()
                    w, _, _ = pack_with_gathered_state(
                        self._scratch, self._owners, *ev)
                    tm["pack"] += time.perf_counter() - t0
                    wires.append(w)
                # the re-plan reads the write nodes' start pointers from
                # their owners; then the owners advance, in stream order
                t0 = time.perf_counter()
                wr = np.unique(np.concatenate(
                    [np.concatenate([b[0], b[1]]) for b in batches]
                ).astype(np.int64))
                ptrs, _ = gather_mail(self._owners, wr)
                ptr0 = np.zeros(d.num_nodes, np.int64)
                ptr0[wr] = ptrs
                for src, dst, t, idx, blk, neg in batches:
                    for ow in self._owners:
                        ow.apply_batch(src, dst, t, blk, neg, e_id=idx)
                tm["exchange"] += time.perf_counter() - t0
            else:
                t0 = time.perf_counter()
                snap = self.packer.snapshot()
                ptr0 = snap[5].copy()
                tm["exchange"] += time.perf_counter() - t0
                for r in ranges:
                    ev = self._range_events(rows_all, blocks_all, r)
                    batches.append(ev)
                    # host r.host's view: the super-batch's start state
                    t0 = time.perf_counter()
                    self.packer.restore(snap)
                    w, _ = self.packer.pack_wire(*ev)
                    tm["pack"] += time.perf_counter() - t0
                    wires.append(w)
                # the serial state for the next super-batch: host=-1 treats
                # every range as remote and replays them all in order
                t0 = time.perf_counter()
                self.packer.restore(snap)
                payloads = [_encode(*b[:4], b[5]) for b in batches]
                SuperBatchExchanger(self.packer, -1, n,
                                    allgather=lambda _p: payloads
                                    ).exchange(*batches[0][:4],
                                               batches[0][5])
                tm["exchange"] += time.perf_counter() - t0
            if self.use_memory:
                t0 = time.perf_counter()
                plans, _ = replan_mail_slots(
                    [b[0] for b in batches], [b[1] for b in batches], ptr0,
                    self.config.memory.mailbox_size, B)
                tm["replan"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                if self.eager_memory:
                    gw = stack_wires(align_wires(
                        [apply_mail_plan(w, pl, d.num_nodes)
                         for w, pl in zip(wires, plans)]))
                else:
                    gw = concat_offset_wires(wires, mail_plans=plans,
                                             num_nodes=d.num_nodes)
            else:
                t0 = time.perf_counter()
                gw = concat_offset_wires(wires)
            tm["stack"] += time.perf_counter() - t0
            total += sb
            if host_only:
                continue
            t0 = time.perf_counter()
            gw = wire_to_device(gw, self.device)
            if self.use_memory:
                self.mem_state, loss, pos, neg = self._composed_step(
                    self.mem_state, self.feats, gw)
            else:
                loss, pos, neg = self._composed_step(self.feats, gw)
            # full super-batches only: every composed event is real
            acc = self._accumulate(acc, loss, pos, neg, valid)
            tm["disp"] += time.perf_counter() - t0
            self._step += n
        if owned:
            # the serial packer takes the owners' state (one O(N) gather an
            # epoch) for the tail, eval, snapshots and checkpoints; the
            # owners take it back at the next epoch's start
            t0 = time.perf_counter()
            restore_serial_from_owners(self.packer, self._owners)
            tm["exchange"] += time.perf_counter() - t0
        if host_only or max_super_batches is not None:
            n_full = len(rows_all)
        for lo in range(n_full, len(rows_all), B):
            ev = self._range_events(
                rows_all, blocks_all,
                EdgeRange(lo, min(lo + B, len(rows_all)), 0))
            t0 = time.perf_counter()
            wire, iw = self._pack_wire(ev, {})
            # every host packs the tail in full: not divided by n in host_s
            tm["pack_tail"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            wire = wire_to_device(wire, self.device)
            _, acc = self._train_step(self._expand(wire, iw), acc)
            tm["disp"] += time.perf_counter() - t0
            total += len(ev[0])
            self._step += 1
        vals = acc.cpu().numpy()                    # ONE fetch
        self.last_epoch_trace = {
            "total_s": time.perf_counter() - t0_epoch,
            "pack_s": tm["pack"] + tm["pack_tail"], "disp_s": tm["disp"],
            "stack_s": tm["stack"], "exchange_s": tm["exchange"],
            "replan_s": tm["replan"],
            # range packs run in parallel across hosts (÷ n); the tail,
            # the exchange, the re-plan and the composition run on every
            # host in full
            "host_s": (tm["pack"] / n + tm["pack_tail"] + tm["exchange"]
                       + tm["replan"] + tm["stack"]),
            "batches": total // B,
            "super_batches": n_sb,
        }
        m = max(float(vals[3]), 1.0)
        return {"loss": float(vals[0]), "ap": float(vals[1] / m),
                "auc": float(vals[2] / m), "events": total}
