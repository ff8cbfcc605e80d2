"""Training/eval engine on torch: the port's counterpart of
tgb_tgn_dgl_tpu/engine/train.py, slimmed to the single-device TGN path,
with the frozen all-ones memory (the reference-parity configuration,
``train.frozen_memory: True``) or the mailbox memory with a GRU/RNN cell
(``configs/TGN-memory.yml``, models/memory.py).

Pipeline per batch, as the JAX Engine runs it by default: the native
packer (data/native_packer.py, csrc/packer.cpp) packs the batch one
batch (at eval one negative chunk) ahead on its own C++ thread into a
``DedupWire`` (ops/wire.py; eval chunks narrowed by ``eval_lean_dedup``)
→ pinned non-blocking copy of the wire to the device (``wire_to_device``)
→ ``expand_dedup`` rebuilds the full ``DevicePack`` there with torch
gathers → one train step (forward, BCE, backward, Adam) or, at eval, one
embedding + scoring pass per negative chunk.  A batch whose intra window
exceeds 255 does not fit the dedup wire: it is packed again on this
thread into the compact wire (or, where that does not fit either, the
plain WirePack).  Protocol fidelity:

  * the neighbor cache resets at each train-epoch start, clocks persist
    (reference epoch_utils.py:175; time_assoc is never reset);
  * validation streams on from the train state without reset and keeps
    inserting events (epoch_utils.py:157; pyg-mem-tgn.py:54-63);
  * eval uses the fixed negatives in column chunks, ranks them by the
    TGB/OGB tie rule, and the metric is the mean of per-batch means
    (epoch_utils.py:163);
  * train loss = BCE(pos→1) + BCE(neg→0), Adam, per-epoch AP/AUC
    (epoch_utils.py:295-317);
  * with the mailbox memory, the ``MemoryState`` (``mem_state``) resets
    with the neighbor cache at each train-epoch start and streams on
    through eval (pyg_epoch_utils.py:11-16).  A train step is apply_mail
    → embed → predict → loss → backward → commit of the detached rows
    (one-step truncated BPTT) → Adam (tgb_tgn_dgl_tpu
    engine/train.py:446-466); every eval chunk runs apply_mail → embed →
    commit, and only the last chunk carries a write plan (:1261-1275).

Metrics accumulate in small tensors on the device; each epoch or eval
pass fetches one of them.  Entry points run on CUDA unless the caller
passes ``device="cpu"``; there is no silent fallback to the CPU.

Not ported yet (NotImplementedError): JODIE/DyRep (``gnn.arch``),
``train.remat``, 'uniform' sampling, bfloat16 compute, vector messages,
gnn.layer > 1.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import TemporalData
from ..data.dependency import dependency_aware_batch
from ..data.native_packer import NativeStreamPacker
from ..data.packer import PackerConfig
from ..models.memory import (MemoryModelConfig, apply_mail, commit,
                             init_memory, init_memory_state)
from ..models.tgnn import (TGNNConfig, bce_loss, init_tgnn, tgnn_embed,
                           tgnn_forward)
from ..ops.wire import (DedupWire, compact_wire, eval_lean_dedup, expand_any,
                        nb_bucket_of, wire_to_device)
from ..utils.config import FrameworkConfig
from .evaluator import ap_auc, parse_eval_metric, rank_metric_from_counts
from .negatives import FixedNegatives, NegLinkSamplerDest


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: raise when there is none rather than run on
    the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain torch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def eval_neg_chunk_size(config, M: int, n_events: int) -> int:
    """Negatives per eval chunk: root slots scale with B*(2+Mc), so cap
    ~24K root slots per chunk (TrainConfig.eval_neg_chunk overrides)."""
    return (config.train.eval_neg_chunk
            or max(1, min(M, 49152 // max(n_events, 1) - 2)))


def _unsupported(config: FrameworkConfig) -> Optional[str]:
    g, tr = config.gnn, config.train
    if g.arch != "transformer_attention":
        return f"gnn.arch={g.arch!r} (JODIE/DyRep)"
    if tr.remat:
        return "train.remat=True"
    if config.sampling.strategy != "recent":
        return f"sampling.strategy={config.sampling.strategy!r}"
    if tr.compute_dtype != "float32":
        return f"train.compute_dtype={tr.compute_dtype!r}"
    return None


class Engine:
    """Single-device engine for the flagship TGNN, with the frozen
    all-ones memory or the mailbox memory (``mem_state``)."""

    def __init__(self, data: TemporalData, config: FrameworkConfig,
                 device=None):
        self.device = resolve_device(device)
        self.data = data
        self.config = config.validate()
        missing = _unsupported(config)
        if missing:
            raise NotImplementedError(f"{missing} is not ported yet")
        tr, g = config.train, config.gnn
        drop = g.override_dropout
        self.use_memory = config.memory.enabled and not tr.frozen_memory
        self.model_cfg = TGNNConfig(
            edge_feat_dim=data.msg_dim,
            hidden_dim=g.dim_out,
            num_heads=g.att_head,
            num_layers=g.layer,
            message_mode=g.message_mode,
            feat_drop=tr.dropout if drop is None else drop,
            attn_drop=tr.att_dropout if drop is None else drop,
            # reference-parity frozen path: memory ≡ ones forever
            # (model_utils.py:270-271), so the embedding reads no table
            const_ones_memory=not self.use_memory,
        )
        init_gen = torch.Generator().manual_seed(tr.seed)
        self.model = init_tgnn(self.model_cfg, init_gen)
        self.mem_cfg = self.mem_state = None
        if self.use_memory:
            m = config.memory
            if m.dim_out != g.dim_out:
                raise ValueError(
                    f"memory.dim_out ({m.dim_out}) must equal gnn.dim_out "
                    f"({g.dim_out}): the embedding reads memory rows as "
                    f"node features")
            self.mem_cfg = MemoryModelConfig(
                num_nodes=data.num_nodes, raw_msg_dim=data.msg_dim,
                memory_dim=m.dim_out, time_dim=m.dim_time,
                mailbox_size=m.mailbox_size, updater=m.memory_update,
                combine=m.mail_combine)
            # drawn after the model's leaves (models/init.py)
            self.model.memory = init_memory(self.mem_cfg, init_gen)
            self.mem_state = init_memory_state(self.mem_cfg, self.device)
        self.model = self.model.to(self.device)
        # the native packer; its library builds here at first use and a
        # failed build raises (data/native_packer.py)
        self.packer = NativeStreamPacker(data.num_nodes, PackerConfig(
            num_neighbors=config.sampling.num_neighbors,
            batch_size=tr.batch_size,
            max_intra_block=tr.max_intra_block,
            mailbox_size=config.memory.mailbox_size,
            strategy=config.sampling.strategy,
            seed=tr.seed,
            layers=g.layer,
        ))
        # counterpart of optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=tr.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.memory = None              # frozen all-ones: never gathered
        self.feats = torch.from_numpy(
            np.ascontiguousarray(data.msg, np.float32)).to(self.device)
        # event times by global row: the eval-lean expansion reads edge
        # times here instead of shipping Δt
        self.times = torch.from_numpy(
            np.ascontiguousarray(data.t, np.float32)).to(self.device)
        self.neg_sampler = NegLinkSamplerDest(data.unique_dst(), seed=tr.seed)
        # every dropout mask of every step comes from this generator, in
        # the order models/init.py documents
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tr.seed + 1)
        self._rows: Dict[str, np.ndarray] = {
            "train": np.nonzero(data.train_mask)[0],
            "val": np.nonzero(data.val_mask)[0],
            "test": np.nonzero(data.test_mask)[0],
        }
        self._blocks: Dict[str, np.ndarray] = {}
        self.last_epoch_trace: Dict[str, float] = {}
        self.last_eval_trace: Dict[str, float] = {}

    # ------------------------------------------------------------ batches
    def blocks_for(self, split: str) -> np.ndarray:
        """Dependency blocks per split, computed once."""
        if split not in self._blocks:
            rows = self._rows[split]
            self._blocks[split] = dependency_aware_batch(
                self.data.src[rows], self.data.dst[rows],
                self.config.train.batch_size)
        return self._blocks[split]

    def _iter_batches(self, split: str):
        rows = self._rows[split]
        blocks = self.blocks_for(split)
        bs = self.config.train.batch_size
        for lo in range(0, len(rows), bs):
            hi = min(lo + bs, len(rows))
            yield lo, hi, rows[lo:hi], blocks[lo:hi]

    # -------------------------------------------------------------- wires
    def _pack_wire(self, args, kw):
        """One batch packed on this thread as a WirePack, narrowed to a
        CompactWire where the wire allows it (JAX ``_maybe_compact``).
        Returns (wire, intra_width)."""
        wire, iw = self.packer.pack_wire(*args, **kw)
        cw = compact_wire(wire, self.data.num_nodes, iw,
                          self.config.memory.mailbox_size)
        return (wire if cw is None else cw), iw

    def _packed(self, jobs, tm):
        """Yields (meta, (wire, intra_width)) for each job (meta, args, kw)
        of ``jobs``, in order.  The native packer runs one job ahead on its
        C++ worker (JAX ``_prefetch_pipelined`` and
        ``_eval_packed_chunks``): job i+1 is submitted before job i is
        yielded, so it packs while the caller dispatches job i.  Submission
        order is stream order, and the pending job is fetched before the
        generator ends, so nothing past ``jobs`` is packed.
        ``tm["fetch_s"]`` gathers the time spent in the packer's fetch (the
        wait for the worker and the read of its buffers)."""

        def fetch(job):
            t0 = time.perf_counter()
            out = self.packer.pack_wire_dedup_fetch()
            tm["fetch_s"] += time.perf_counter() - t0
            # None: P > 255 and the state untouched, so pack the same
            # batch on this thread
            return self._pack_wire(job[1], job[2]) if out is None else out

        pend = None
        for job in jobs:
            ready = None if pend is None else fetch(pend)
            # refused only for an empty batch or one over batch_size,
            # which _iter_batches never yields
            accepted = self.packer.pack_wire_dedup_submit(*job[1], **job[2])
            assert accepted, "the packer refused a batch"
            if ready is not None:
                yield pend[0], ready
            pend = job
        if pend is not None:
            yield pend[0], fetch(pend)

    def _expand(self, wire, intra_width):
        return expand_any(wire, self.config.sampling.num_neighbors,
                          intra_width, self.data.num_nodes, self.times)

    def _train_jobs(self):
        """The train split's batches, or its first ``sanity_batches``."""
        d = self.data
        batches = self._iter_batches("train")
        sanity = self.config.train.sanity_batches
        if sanity:
            batches = itertools.islice(batches, sanity)
        for lo, hi, rows, blk in batches:
            src, dst, t = d.src[rows], d.dst[rows], d.t[rows]
            yield (lo, hi), (src, dst, t, rows, blk,
                             self.neg_sampler.sample(dst)), {}

    def _eval_jobs(self, split: str, fixed: FixedNegatives, B: int):
        """One job per negative chunk of the column-chunk protocol (JAX
        ``_eval_chunk_args``); meta = (lo, hi, blk, first, last, mask_c)
        with mask_c the (B, Mc) mask of real negatives in pad+mask mode."""
        d = self.data
        for lo, hi, rows, blk in self._iter_batches(split):
            src, dst, t = d.src[rows], d.dst[rows], d.t[rows]
            neg, mask = fixed.query_batch(lo, hi)
            neg2d = np.asarray(neg).reshape(len(rows), -1)
            M = neg2d.shape[1]
            mask2d = None
            if mask is not None:
                mask2d = np.zeros((B, M), bool)
                mask2d[:len(rows)] = mask
            Mc = eval_neg_chunk_size(self.config, M, hi - lo)
            n_chunks = -(-M // Mc)
            for ci in range(n_chunks):
                last = ci == n_chunks - 1
                cols = slice(ci * Mc, (ci + 1) * Mc)
                mask_c = None if mask2d is None else mask2d[:, cols]
                # the stream state (cache insert, mail writes, ring
                # pointers) advances on the last chunk only
                yield ((lo, hi, blk, ci == 0, last, mask_c),
                       (src, dst, t, rows, blk, neg2d[:, cols]),
                       dict(eval_mode=True, insert=last, write_mail=last))

    # -------------------------------------------------------------- train
    def _apply_mail(self, pack):
        return apply_mail(self.model.memory, self.mem_cfg, self.mem_state,
                          pack.uniq_nid, self.feats)

    def _commit(self, pack, mem_rows, lu_rows) -> None:
        self.mem_state = commit(
            self.mem_cfg, self.mem_state, pack.uniq_nid, mem_rows.detach(),
            lu_rows.detach(), pack.mw_node, pack.mw_slot, pack.mw_partner,
            pack.mw_t, pack.mw_eid)

    def _train_step(self, pack, acc: torch.Tensor):
        """One Adam step on a device pack (tgb_tgn_dgl_tpu
        engine/train.py:440-496); returns (loss, acc) with the running
        accumulator [Σ loss·n, Σ ap, Σ auc, batches] (:369-379)."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.use_memory:
            mem_rows, lu_rows = self._apply_mail(pack)
            pos, neg = tgnn_forward(self.model, self.model_cfg, mem_rows,
                                    self.feats, pack, train=True,
                                    generator=self.generator, local=True)
        else:
            pos, neg = tgnn_forward(self.model, self.model_cfg, self.memory,
                                    self.feats, pack, train=True,
                                    generator=self.generator)
        loss = bce_loss(pos, neg, pack.ev_valid)
        loss.backward()
        if self.use_memory:
            # after backward: the state's tensors are written in place
            self._commit(pack, mem_rows, lu_rows)
        self.optimizer.step()
        with torch.no_grad():
            valid = pack.ev_valid
            neg1 = neg if neg.dim() == 1 else neg[:, 0]
            ap, auc = ap_auc(torch.sigmoid(pos), torch.sigmoid(neg1), valid)
            acc = acc + torch.stack([loss * valid.sum(), ap, auc,
                                     torch.ones((), device=acc.device)])
        return loss.detach(), acc

    def train_epoch(self) -> Dict[str, float]:
        """One pass over the train split (or its first
        ``train.sanity_batches`` batches; a batch past that limit is not
        packed, so the stream state stops where training stopped).
        Returns loss (Σ loss·n, as the JAX engine reports it), mean AP,
        mean AUC and the number of events.  ``last_epoch_trace`` holds
        ``pack_s``, the time this thread spent getting each next device
        wire (the wait for the packer, the submit of the next batch, the
        copy's enqueue), its parts ``fetch_s`` in the packer's fetch and
        ``copy_s`` in ``wire_to_device``, and ``disp_s``, the time it spent
        dispatching the expansion and the train step."""
        self.packer.reset_cache()
        if self.use_memory:
            # memory and cache reset together (pyg_epoch_utils.py:11-16)
            self.mem_state = init_memory_state(self.mem_cfg, self.device)
        acc = torch.zeros(4, dtype=torch.float32, device=self.device)
        total = nb = 0
        pack_s = disp_s = 0.0
        tm = {"fetch_s": 0.0, "copy_s": 0.0}
        t0 = time.perf_counter()
        wires = self._packed(self._train_jobs(), tm)
        while True:
            t1 = time.perf_counter()
            nxt = next(wires, None)
            if nxt is None:
                pack_s += time.perf_counter() - t1
                break
            (lo, hi), (wire, iw) = nxt
            tc = time.perf_counter()
            wire = wire_to_device(wire, self.device)
            t2 = time.perf_counter()
            tm["copy_s"] += t2 - tc
            pack_s += t2 - t1
            _, acc = self._train_step(self._expand(wire, iw), acc)
            disp_s += time.perf_counter() - t2
            nb += 1
            total += hi - lo
        vals = acc.cpu().numpy()                    # ONE fetch
        self.last_epoch_trace = {"total_s": time.perf_counter() - t0,
                                 "pack_s": pack_s, "disp_s": disp_s,
                                 **tm, "batches": nb}
        n = max(float(vals[3]), 1.0)
        return {"loss": float(vals[0]), "ap": float(vals[1] / n),
                "auc": float(vals[2] / n), "events": total}

    # --------------------------------------------------------------- eval
    def _score_counts(self, embed, pack, opt, pes, neg_mask):
        """Edge scoring into per-event rank counts (tgb_tgn_dgl_tpu
        engine/train.py:623-643).  ``neg_mask`` (B, Mc) marks the real
        negative columns in pad+mask mode, else None."""
        pos, neg = self.model.pred(embed[pack.ev_src_slot.long()],
                                   embed[pack.ev_pos_slot.long()],
                                   embed[pack.ev_neg_slot.long()])
        neg2 = neg if neg.dim() == 2 else neg[:, None]
        p = pos[:, None]
        gt = neg2 > p
        ge = neg2 >= p
        if neg_mask is not None:
            gt = gt & neg_mask
            ge = ge & neg_mask
        return opt + gt.sum(dim=1), pes + ge.sum(dim=1)

    @torch.no_grad()
    def evaluate(self, split: str = "val") -> float:
        """Streaming TGB evaluation of ``split`` by the column-chunk
        protocol: each batch's fixed negatives go through the model in
        chunks of ``eval_neg_chunk_size``; ranks add up across chunks, and
        only the LAST chunk of a batch inserts the batch into the stream
        state (tgb_tgn_dgl_tpu engine/train.py:1599-1627)."""
        d = self.data
        ns = d.val_ns if split == "val" else d.test_ns
        if ns is None:
            raise ValueError(f"no fixed negatives for split '{split}'")
        fixed = FixedNegatives(ns, mode=self.config.train.eval_neg_mode)
        B = self.config.train.batch_size
        kind, k = parse_eval_metric(d.eval_metric)
        acc = torch.zeros(2, dtype=torch.float32, device=self.device)
        ar = torch.arange(B, device=self.device)
        # the eval-lean clock grid's block width, fixed for the pass
        nb_bucket = nb_bucket_of(self.blocks_for(split))
        chunks = 0
        pack_s = disp_s = 0.0
        tm = {"fetch_s": 0.0, "copy_s": 0.0}
        t0 = time.perf_counter()
        wires = self._packed(self._eval_jobs(split, fixed, B), tm)
        while True:
            t1 = time.perf_counter()
            nxt = next(wires, None)
            if nxt is None:
                pack_s += time.perf_counter() - t1
                break
            (lo, hi, blk, first, last, mask_c), (wire, iw) = nxt
            if isinstance(wire, DedupWire):
                wire = eval_lean_dedup(wire, blk, nb_bucket)
            tc = time.perf_counter()
            wire = wire_to_device(wire, self.device)
            if mask_c is not None:
                mask_c = torch.from_numpy(mask_c).to(self.device)
            t2 = time.perf_counter()
            tm["copy_s"] += t2 - tc
            pack_s += t2 - t1
            if first:
                opt = torch.zeros(B, dtype=torch.int64, device=self.device)
                pes = torch.zeros(B, dtype=torch.int64, device=self.device)
            pack = self._expand(wire, iw)
            if self.use_memory:
                # applied mail is cleared by the commit, so applying and
                # committing on every chunk is idempotent; only the last
                # chunk carries a write plan
                mem_rows, lu_rows = self._apply_mail(pack)
                embed = tgnn_embed(self.model, self.model_cfg, mem_rows,
                                   self.feats, pack, train=False, local=True)
                self._commit(pack, mem_rows, lu_rows)
            else:
                embed = tgnn_embed(self.model, self.model_cfg, self.memory,
                                   self.feats, pack, train=False)
            opt, pes = self._score_counts(embed, pack, opt, pes, mask_c)
            chunks += 1
            if last:
                valid = ar < (hi - lo)
                val = rank_metric_from_counts(opt, pes, kind, k)
                val = torch.where(valid, val, 0.0)
                batch_mean = val.sum() / torch.clamp(valid.sum(), min=1)
                acc = acc + torch.stack([batch_mean,
                                         torch.ones((), device=self.device)])
            disp_s += time.perf_counter() - t2
        vals = acc.cpu().numpy()                    # ONE fetch
        self.last_eval_trace = {"total_s": time.perf_counter() - t0,
                                "pack_s": pack_s, "disp_s": disp_s,
                                **tm, "chunks": chunks}
        return float(vals[0] / max(float(vals[1]), 1.0))
