"""Training/eval engine on torch: the port's counterpart of
tgb_tgn_dgl_tpu/engine/train.py, slimmed to the single-device path of
its three model families (``gnn.arch``, models/factory.py):

  * TGN with the frozen all-ones memory (the reference-parity
    configuration, ``train.frozen_memory: True``) or the mailbox memory
    with a GRU/RNN cell (``configs/TGN-memory.yml``, models/memory.py),
    scalar or vector messages, one or more stacked attention layers
    (``configs/TGN-2layer.yml``);
  * JODIE (``gnn.arch: identity``, ``configs/JODIE.yml``): the mailbox
    memory with the time-projection embedding and no graph attention;
  * DyRep (``gnn.arch: dyrep``, ``configs/DyRep.yml``): TGN's attention
    and the eager-mail memory (models/variants.py), whose stored messages
    are computed at the event's batch, from its embeddings;
  * DyGFormer (``gnn.arch: dygformer``, ``configs/DyGFormer.yml``,
    models/dygformer.py): no memory; it scores pairs, each (src, dst) and
    (src, negative) through a Transformer over the two ends' histories.
    Every batch and eval chunk is packed on this thread by the packer's
    per-event history mode (``pack_history``: each end's latest
    interactions earlier in the stream, the batch's own earlier events
    included) into a ``HistoryWire``, which the step reads as it crosses.
    The slot-unique eval (its reason: ``gnn.arch dygformer scores
    pairs``) and device-cache mode stay off; eval runs the column-chunk
    protocol, the pairs of a chunk encoded ``EVAL_PAIRS`` at a time.

JODIE and DyRep always run with their memory, whatever
``train.frozen_memory`` says.

Two opt-in transports keep part of the stream state on the device, as in
the JAX Engine (both off by default):

  * device-cache mode (``train.device_cache``; ops/lean_wire.py): TGN at
    one layer keeps the neighbor cache and the clocks on the card
    (``sstate``, a ``StreamDeviceState``).  The lean packer
    (data/lean_packer.py) packs each batch and chunk on this thread, when
    it is reached, into an event-only ``LeanWire``; ``expand_lean``
    rebuilds the DevicePack from it and the resident state, and
    ``advance_stream`` closes the batch (at column-chunk eval, on the
    last chunk only).  Eval then takes the column-chunk protocol (gate
    reason ``device_cache mode``).  Another configuration with the knob
    says why once and runs the host packer (``device_cache`` is False);
  * the train-lean wire (``train.wire_train_lean``; one layer, the host
    packer): each train dedup wire ships the pre-batch clock rows of its
    unique table in place of its Δt fields (``train_lean_dedup``); the
    packer's clocks are read between the fetch of one batch and the
    submit of the next.

Pipeline per batch, as the JAX Engine runs it by default: the native
packer (data/native_packer.py, csrc/packer.cpp) packs the batch one
batch (at column-chunk eval one negative chunk) ahead on its own C++
thread into a ``DedupWire`` (ops/wire.py; eval wires narrowed by
``eval_lean_dedup``) → pinned non-blocking copy of the wire to the device
(``wire_to_device``) → ``expand_dedup`` rebuilds the full ``DevicePack``
there with torch gathers → one train step (forward, BCE, backward, Adam)
or, at eval, the embedding and scoring of the batch.  A train batch or
column-chunk eval chunk whose intra window exceeds 255 does not fit the
dedup wire: it is packed again on this thread into the compact wire (or,
where that does not fit either, the plain WirePack).  At gnn.layer > 1
the packer does not run ahead: the dedup wire carries no same-block root
slots, so every batch and chunk is packed on this thread, when it is
reached, into the compact wire with its rslot fields (the JAX Engine's
``sync_pack``).

Eval runs the slot-unique protocol (the JAX Engine's default): each
batch is packed once with all its negatives, every unique (node, block)
root slot is embedded once, in chunks of at most ``EVAL_UNIQUE_SLOTS``
slots into one table, and ranks come from gathers into it.  Where the
stream cannot take it (gnn.layer > 1, an intra cap over 255 or none, a
negative timestamp, over 65,536 blocks in a batch), the engine says why
once and runs the column-chunk protocol, which gives the same ranks and
state.
The port has no ``eval_slot_unique`` knob and no JAX "auto" dedup
estimate: slot-unique embeds at most the root slots column chunks do,
whatever the dedup.  Protocol fidelity:

  * the neighbor cache resets at each train-epoch start, clocks persist
    (reference epoch_utils.py:175; time_assoc is never reset);
  * validation streams on from the train state without reset and keeps
    inserting events (epoch_utils.py:157; pyg-mem-tgn.py:54-63);
  * eval ranks the fixed negatives by the TGB/OGB tie rule, and the
    metric is the mean of per-batch means (epoch_utils.py:163);
  * train loss = BCE(pos→1) + BCE(neg→0), Adam, per-epoch AP/AUC
    (epoch_utils.py:295-317);
  * with the mailbox memory, the ``MemoryState`` (``mem_state``) resets
    with the neighbor cache at each train-epoch start and streams on
    through eval (pyg_epoch_utils.py:11-16).  A train step is apply_mail
    → embed → predict → loss → backward → commit of the detached rows
    (one-step truncated BPTT) → Adam (tgb_tgn_dgl_tpu
    engine/train.py:446-466).  A slot-unique eval batch applies the mail
    once, embeds, scores and commits with the batch's write plan
    (:754-878); a column-chunk eval chunk runs apply_mail → embed →
    commit, and only the last chunk carries a write plan (:1261-1275);
  * DyRep's eager mail is built after ``backward()`` and before the Adam
    step, from the detached step embedding and the pre-step time encoder
    (JAX builds it from the step's parameters, :414-421), then committed;
    at eval each slot-unique batch builds it from its full embedding
    table and the whole (R2,) slot map (:847-865), each column chunk
    from its own embedding (:1233-1252).

Metrics accumulate in small tensors on the device; each epoch or eval
pass fetches one of them.  Entry points run on CUDA unless the caller
passes ``device="cpu"``; there is no silent fallback to the CPU.

``fit`` is the epoch loop of tgb_tgn_dgl_tpu engine/train.py:2010-2081
(a val pass every epoch, jsonl metrics, checkpoints every N epochs, early
stopping that restores the best parameters, and the ``val_snapshot``
protection of training from the streaming eval), after ``warm_buckets``
once, as the JAX ``fit`` (:2023-2025); ``save_checkpoint`` /
``load_checkpoint`` hold the full state a run resumes from exactly
(:2109-2187, engine/checkpoint.py), and the cursors ``_epoch`` and
``_step`` count the epochs and batches trained.

Three config knobs change the path, as in the JAX Engine:

  * ``sampling.strategy: uniform``: the numpy ``StreamPacker``
    (data/packer.py) with the t-CSR of the whole stream (data/tcsr.py,
    built by csrc/hostops.cpp) packs every batch and chunk on this thread
    into the compact wire (``pack_wire`` + ``compact_wire``); each block
    of a pack samples its roots' K in-edges uniformly from their history
    before their clock, with a seed drawn from the packer's ``_rng``.  The
    slot-unique gate closes ("wire_dedup off or strategy!=recent": column
    chunks), and device-cache mode and the train-lean wire stay off;
  * ``train.compute_dtype: bfloat16``: the embedding's dense pass in
    bfloat16 (models/tgnn.py) around the same fp32 attention kernels, and
    the slot-unique eval's embedding table in bfloat16; parameters, Adam,
    the memory and the checkpoint stay fp32;
  * ``train.remat``: the memory and DyRep train steps recompute the
    embedding in the backward (``torch.utils.checkpoint``), its dropout
    masks replayed from the engine generator's state at the step, so the
    step is the one without remat bit for bit, at one more forward launch
    a step.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.dataset import TemporalData
from ..data.dependency import dependency_aware_batch
from ..data.lean_packer import NativeLeanPacker
from ..data.native_packer import NativeStreamPacker
from ..data.packer import PackerConfig, StreamPacker
from ..data.tcsr import build_tcsr
from ..models.dygformer import (DyGFormerConfig, encode_pairs,
                               pair_bce_loss, pair_tokens, split_logits)
from ..models.factory import PAIR_ARCHS, arch_embed, arch_predict, init_arch
from ..models.memory import (MemoryModelConfig, apply_mail, commit,
                             init_memory, init_memory_state)
from ..models.tgnn import TGNNConfig, bce_loss
from ..models.variants import (EagerMemoryConfig, dyrep_messages,
                               eager_apply_mail, eager_commit,
                               init_eager_memory, init_eager_memory_state)
from ..ops import gather
from ..ops.lean_wire import (LeanWire, advance_stream, clone_stream_state,
                             expand_lean, init_stream_device_state,
                             reset_stream_cache)
from ..ops.neighbor_cache import NeighborCacheState
from ..ops.wire import (DedupWire, compact_wire, eval_lean_dedup, expand_any,
                        nb_bucket_of, train_lean_dedup, wire_to_device)
from ..utils.config import FrameworkConfig
from ..utils.metrics import MetricsLogger, SectionTimers, span
from .checkpoint import (CHECKPOINT_SUFFIX, EarlyStopMonitor, load_state,
                         rng_state_from_array, rng_state_to_array, save_state)
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


# train.compute_dtype -> the embedding's dense dtype
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the slot-unique gate's reason under 'uniform' (tgb_tgn_dgl_tpu
# engine/train.py:698)
UNIFORM_GATE = "wire_dedup off or strategy!=recent"

# slot-unique eval: root slots a batch embeds per embedding chunk, and the
# negative columns a batch scores per chunk (tgb_tgn_dgl_tpu
# engine/train.py:904,920)
EVAL_UNIQUE_SLOTS = 49152
EVAL_SCORE_COLUMNS = 256
# DyGFormer's eval: pairs a column chunk encodes at a time (the
# feed-forward activations of 8,192 pairs take ~3.4 GB at the published
# widths)
EVAL_PAIRS = 8192
# its slot-unique gate's reason
PAIR_GATE = "gnn.arch dygformer scores pairs"
# the root-slot fields of a DedupWire: each embed chunk takes its rows
SLOT_FIELDS = ("root_loc", "root_cr", "intra_lo", "intra_cnt", "intra_start",
               "root_blk")


def eval_neg_chunk_size(config, M: int, n_events: int) -> int:
    """Negatives per eval chunk: root slots scale with B*(2+Mc), so cap
    ~24K root slots per chunk (TrainConfig.eval_neg_chunk overrides)."""
    return (config.train.eval_neg_chunk
            or max(1, min(M, 49152 // max(n_events, 1) - 2)))


class Engine:
    """Single-device engine for TGN (the frozen all-ones memory or the
    mailbox memory), JODIE and DyRep; ``mem_state`` holds the memory's
    stream state (a ``MemoryState``, DyRep's ``EagerMemoryState``)."""

    # slot-unique eval pads each embed chunk to a multiple of this many
    # root slots (the sharded engine splits a chunk over its dp ranks)
    _root_multiple = 1

    def __init__(self, data: TemporalData, config: FrameworkConfig,
                 device=None):
        self.device = resolve_device(device)
        self.data = data
        self.config = config.validate()
        tr, g = config.train, config.gnn
        self.uniform = config.sampling.strategy == "uniform"
        drop = g.override_dropout
        # JODIE and DyRep are memory models by definition (tgb_tgn_dgl_tpu
        # engine/train.py:216-230); TGN takes the mailbox memory unless
        # the reference's frozen all-ones quirk is asked for
        self.arch = g.arch
        self.pairs = self.arch in PAIR_ARCHS
        if self.arch in ("identity", "dyrep"):
            if not config.memory.enabled:
                raise ValueError(f"gnn.arch {self.arch!r} needs the memory "
                                 f"(memory.type: 'node')")
            self.use_memory = True
        elif self.pairs:
            if config.memory.enabled and not tr.frozen_memory:
                raise ValueError(f"gnn.arch {self.arch!r} has no memory "
                                 f"(memory.type: 'none')")
            if self.uniform:
                raise ValueError(f"gnn.arch {self.arch!r} reads its "
                                 f"histories from the recency cache "
                                 f"(sampling.strategy: 'recent')")
            self.use_memory = False
        else:
            self.use_memory = config.memory.enabled and not tr.frozen_memory
        # DyRep's messages hold embeddings: the eager-mail memory
        self.eager_memory = self.arch == "dyrep"
        self.model_cfg = TGNNConfig(
            edge_feat_dim=data.msg_dim,
            hidden_dim=g.dim_out,
            num_heads=g.att_head,
            num_layers=g.layer,
            message_mode=g.message_mode,
            feat_drop=tr.dropout if drop is None else drop,
            attn_drop=tr.att_dropout if drop is None else drop,
            compute_dtype=COMPUTE_DTYPES[tr.compute_dtype],
            # reference-parity frozen path: memory ≡ ones forever
            # (model_utils.py:270-271), so the embedding reads no table
            const_ones_memory=not self.use_memory,
        )
        # DyGFormer's sizes (its token width is four channels, its
        # histories the sequence less the end itself)
        self.pair_cfg = None if not self.pairs else DyGFormerConfig(
            node_dim=g.node_feat_dim, edge_dim=data.msg_dim,
            time_dim=g.dim_time, channel=g.channel_embedding_dim,
            patch=g.patch_size, seq_len=g.max_input_sequence_length,
            layers=g.layer, heads=g.att_head,
            drop=tr.dropout if drop is None else drop,
            att_drop=tr.att_dropout if drop is None else drop)
        init_gen = torch.Generator().manual_seed(tr.seed)
        self.model = init_arch(self.model_cfg, self.arch, init_gen,
                               self.pair_cfg)
        self.mem_cfg = self.mem_state = None
        if self.use_memory:
            m = config.memory
            if m.dim_out != g.dim_out:
                raise ValueError(
                    f"memory.dim_out ({m.dim_out}) must equal gnn.dim_out "
                    f"({g.dim_out}): the embedding reads memory rows as "
                    f"node features")
            # drawn after the model's leaves (models/init.py)
            if self.eager_memory:
                D = m.dim_out
                # mail = cat(self, partner, raw, Δt-enc): the reference's
                # IdentityMessage width (modules/msg_func.py:15)
                self.mem_cfg = EagerMemoryConfig(
                    num_nodes=data.num_nodes,
                    mail_dim=2 * D + data.msg_dim + D, memory_dim=D,
                    updater=m.memory_update, combine=m.mail_combine,
                    use_src_emb=m.use_src_emb_in_msg,
                    use_dst_emb=m.use_dst_emb_in_msg)
                self.model.memory = init_eager_memory(self.mem_cfg, init_gen)
            else:
                self.mem_cfg = MemoryModelConfig(
                    num_nodes=data.num_nodes, raw_msg_dim=data.msg_dim,
                    memory_dim=m.dim_out, time_dim=m.dim_time,
                    mailbox_size=m.mailbox_size, updater=m.memory_update,
                    combine=m.mail_combine)
                self.model.memory = init_memory(self.mem_cfg, init_gen)
            self.mem_state = self._fresh_memory_state()
        self.model = self.model.to(self.device)
        pk_cfg = PackerConfig(
            num_neighbors=(self.pair_cfg.history if self.pairs
                           else config.sampling.num_neighbors),
            batch_size=tr.batch_size,
            max_intra_block=tr.max_intra_block,
            mailbox_size=config.memory.mailbox_size,
            strategy=config.sampling.strategy,
            seed=tr.seed,
            layers=1 if self.pairs else g.layer,
        )
        # device-cache mode: the gate of tgb_tgn_dgl_tpu
        # engine/train.py:181-185
        self.device_cache = False
        if tr.device_cache:
            off = ("gnn.arch!=transformer_attention"
                   if g.arch != "transformer_attention" else
                   "gnn.layer>1" if g.layer != 1 else
                   "sampling.strategy!=recent" if self.uniform else None)
            self.device_cache = off is None
            if off:
                print(f"[train] device-cache mode off ({off}); using the "
                      f"host packer", flush=True)
        # the train-lean wire rides on the dedup wire: one layer, host
        # packer, 'recent'
        self.train_lean = (tr.wire_train_lean and not self.device_cache
                           and g.layer == 1 and not self.uniform
                           and not self.pairs)
        # every batch and chunk packed on this thread when it is reached:
        # the worker's dedup wire carries no rslot (gnn.layer > 1) and no
        # t-CSR draw ('uniform'), the lean packer has no worker, and a
        # history pack is no job of the worker's
        self._sync_pack = (g.layer > 1 or self.device_cache or self.uniform
                           or self.pairs)
        self.sstate = None
        # the packer's library builds here at first use and a failed build
        # raises (data/native_packer.py, data/hostops.py)
        if self.device_cache:
            self.packer = NativeLeanPacker(data.num_nodes, pk_cfg)
            self.sstate = init_stream_device_state(
                data.num_nodes, config.sampling.num_neighbors, self.device)
        elif self.uniform:
            # the JAX factory's numpy packer for any strategy but 'recent'
            # (tgb_tgn_dgl_tpu data/native_packer.py:733), with the t-CSR
            # of the whole stream (engine/train.py:195-198)
            self.packer = StreamPacker(data.num_nodes, pk_cfg)
            self.packer.set_tcsr(build_tcsr(data.src, data.dst, data.t,
                                            data.num_nodes))
        else:
            self.packer = NativeStreamPacker(data.num_nodes, pk_cfg)
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
        # DyGFormer's node features: the stream has none, so DyGLib's zero
        # rows of the node feature width, gathered like any feature
        self.node_feats = None if not self.pairs else torch.zeros(
            (data.num_nodes, self.pair_cfg.node_dim), device=self.device)
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
        self._nb_buckets: Dict[str, int] = {}
        self.last_epoch_trace: Dict[str, float] = {}
        self.last_eval_trace: Dict[str, object] = {}
        self._eval_gate_logged: set = set()
        self._step = 0       # batches trained
        self._epoch = 0      # epochs trained (the resume cursor)
        self._warmed = False  # warm_buckets has run

    # ------------------------------------------------------------ batches
    def blocks_for(self, split: str) -> np.ndarray:
        """Dependency blocks per split, computed once."""
        if split not in self._blocks:
            rows = self._rows[split]
            self._blocks[split] = dependency_aware_batch(
                self.data.src[rows], self.data.dst[rows],
                self.config.train.batch_size,
                num_threads=self.config.sampling.num_thread)
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
        """One batch packed on this thread: in device-cache mode a
        LeanWire, else a WirePack narrowed to a CompactWire where the wire
        allows it (JAX ``_maybe_compact``).  Returns (wire,
        intra_width)."""
        if self.pairs:
            return self.packer.pack_history(*args, **kw)
        wire, iw = self.packer.pack_wire(*args, **kw)
        if self.device_cache:
            return wire, iw
        cw = compact_wire(wire, self.data.num_nodes, iw,
                          self.config.memory.mailbox_size)
        return (wire if cw is None else cw), iw

    def _train_nb_bucket(self, split: str = "train") -> int:
        """The block-count bucket of ``split``'s train-lean clock grid,
        fixed per split (tgb_tgn_dgl_tpu engine/train.py:1525-1533)."""
        if split not in self._nb_buckets:
            self._nb_buckets[split] = nb_bucket_of(self.blocks_for(split))
        return self._nb_buckets[split]

    def _packed(self, jobs, nb_bucket: int = 0):
        """Yields (meta, (wire, intra_width)) for each job (meta, args, kw)
        of ``jobs``, in order.  The native packer runs one job ahead on its
        C++ worker (JAX ``_prefetch_pipelined`` and
        ``_eval_packed_chunks``): job i+1 is submitted before job i is
        yielded, so it packs while the caller dispatches job i.  Submission
        order is stream order, and the pending job is fetched before the
        generator ends, so nothing past ``jobs`` is packed.
        The ``feed.fetch`` span holds the packer's fetch (the wait for the
        worker and the read of its buffers).

        At gnn.layer > 1 the worker cannot take the job (its dedup wire
        carries no rslot; JAX ``sync_pack``, engine/train.py:1546-1597),
        under 'uniform' the numpy packer has no worker (the JAX Engine
        packs it on its main thread, :1506-1511), and in device-cache mode
        the lean packer has none (JAX packs lean wires on its main thread,
        :1494-1498, :1660-1663): each job is packed on this thread when
        it is reached, and ``feed.fetch`` holds that whole pack.

        With ``nb_bucket`` (train jobs with the train-lean wire) each dedup
        wire goes train-lean: the packer's clocks are read after the
        previous job's fetch, whose pack advanced them, and before this
        job's submit hands it to the worker (JAX :1544-1563).  A job
        handed back (P > 255) is packed on this thread as a compact wire,
        with its Δt, inside ``feed.fetch`` too."""
        if self._sync_pack:
            for job in jobs:
                with span("feed.fetch"):
                    out = self._pack_wire(job[1], job[2])
                yield job[0], out
            return

        def fetch(job, clock):
            with span("feed.fetch"):
                out = self.packer.pack_wire_dedup_fetch()
                # None: P > 255 and the state untouched, so pack the same
                # batch on this thread
                if out is None:
                    return self._pack_wire(job[1], job[2])
            if clock is not None:
                out = (train_lean_dedup(out[0], job[1][4], nb_bucket,
                                        clock), out[1])
            return out

        pend = None
        for job in jobs:
            ready = None if pend is None else fetch(*pend)
            # the pre-batch clocks: no job is pending on the worker here
            clock = self.packer.clock_snapshot() if nb_bucket else None
            # refused only for an empty batch or one over batch_size,
            # which _iter_batches never yields
            accepted = self.packer.pack_wire_dedup_submit(*job[1], **job[2])
            assert accepted, "the packer refused a batch"
            if ready is not None:
                yield pend[0][0], ready
            pend = (job, clock)
        if pend is not None:
            yield pend[0][0], fetch(*pend)

    def _expand(self, wire, intra_width):
        """The DevicePack of a device wire (in device-cache mode a train
        batch's LeanWire); a HistoryWire is read as it is."""
        if self.pairs:
            return wire
        if self.device_cache:
            return self._expand_lean(wire, intra_width, eval_mode=False)
        return expand_any(wire, self.config.sampling.num_neighbors,
                          intra_width, self.data.num_nodes, self.times)

    def _expand_lean(self, wire: LeanWire, intra_width, eval_mode: bool):
        """The DevicePack of a LeanWire from the resident stream state;
        ``eval_mode`` picks the clock rule."""
        return expand_lean(
            wire, self.sstate, self.config.sampling.num_neighbors,
            intra_width, self.data.num_nodes, eval_mode=eval_mode,
            batch_size=self.config.train.batch_size)[0]

    def _advance(self, wire, eval_mode: bool) -> None:
        """Device-cache mode: close the batch on the resident state."""
        self.sstate = advance_stream(self.sstate, wire, self.data.num_nodes,
                                     eval_mode=eval_mode)

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
    def _fresh_memory_state(self):
        """The memory's zero state (``reset_memory``, reference
        model_utils.py:273-288)."""
        if self.eager_memory:
            return init_eager_memory_state(
                self.mem_cfg, self.config.memory.mailbox_size, self.device)
        return init_memory_state(self.mem_cfg, self.device)

    def _apply_mail(self, pack):
        """The batch's read set with its pending mail applied: (memory
        rows, last-update rows), in the ``step.memory.apply`` span."""
        with span("step.memory.apply"):
            if self.eager_memory:
                return eager_apply_mail(self.model.memory, self.mem_cfg,
                                        self.mem_state, pack.uniq_nid)
            return apply_mail(self.model.memory, self.mem_cfg,
                              self.mem_state, pack.uniq_nid, self.feats)

    def _commit(self, pack, mem_rows, lu_rows, embed=None) -> None:
        """Write the batch into the memory state, in place.  DyRep's mail
        is built here from ``embed``, the batch's root-slot embeddings, and
        the model's current time encoder: call it before the Adam step.
        In the ``step.memory.commit`` span."""
        with span("step.memory.commit"):
            mem_rows, lu_rows = mem_rows.detach(), lu_rows.detach()
            if not self.eager_memory:
                self.mem_state = commit(
                    self.mem_cfg, self.mem_state, pack.uniq_nid, mem_rows,
                    lu_rows, pack.mw_node, pack.mw_slot, pack.mw_partner,
                    pack.mw_t, pack.mw_eid)
                return
            mail = dyrep_messages(self.mem_cfg, embed.detach(), pack,
                                  self.feats, self.model.time, mem_rows,
                                  lu_rows)
            self.mem_state = eager_commit(
                self.mem_cfg, self.mem_state, pack.uniq_nid, mem_rows,
                lu_rows, pack.mw_node, pack.mw_slot, mail, pack.mw_t,
                pack.mw_eid)

    def _embed(self, pack, mem_rows, lu_rows, train: bool):
        """Root-slot embeddings of a device pack by the model's arch: from
        the batch's applied memory rows with the memory (recomputed in the
        backward at train with ``train.remat``), else the frozen ones."""
        if self.use_memory:
            if train and self.config.train.remat:
                return self._remat_embed(pack, mem_rows, lu_rows)
            return arch_embed(self.model, self.arch, self.model_cfg,
                              mem_rows, lu_rows, self.feats, pack,
                              train=train, generator=self.generator,
                              local=True)
        return arch_embed(self.model, self.arch, self.model_cfg, self.memory,
                          None, self.feats, pack, train=train,
                          generator=self.generator, local=False)

    def _remat_embed(self, pack, mem_rows, lu_rows):
        """The memory-mode train embedding under ``torch.utils.checkpoint``
        (the JAX ``jax.checkpoint`` of the embed closure,
        engine/train.py:383-396): its activations are recomputed in the
        backward instead of kept.  The dropout masks come from a generator
        of their own set to ``self.generator``'s state at the step, in the
        forward and again in the recompute (checkpoint's
        ``preserve_rng_state`` restores the default generators only, and
        the recompute would otherwise draw new masks); ``self.generator``
        then goes on from where the forward's draws left it, as without
        remat."""
        state = self.generator.get_state()
        gens = []

        def run(mem_rows, lu_rows):
            gen = torch.Generator(device=self.device)
            gen.set_state(state)
            gens.append(gen)
            return arch_embed(self.model, self.arch, self.model_cfg,
                              mem_rows, lu_rows, self.feats, pack,
                              train=True, generator=gen, local=True)

        embed = checkpoint(run, mem_rows, lu_rows, use_reentrant=False,
                           preserve_rng_state=False)
        self.generator.set_state(gens[0].get_state())
        return embed

    def _train_step(self, pack, acc: torch.Tensor):
        """One Adam step on a device pack (tgb_tgn_dgl_tpu
        engine/train.py:397-496); returns (loss, acc) with the running
        accumulator [Σ loss·n, Σ ap, Σ auc, batches] (:369-379).  Its
        parts are the spans ``step.memory.apply``, ``step.embed`` (with
        the prediction and the loss; DyGFormer's parts in it are
        ``step.embed.pairs`` and ``step.embed.encoder``),
        ``step.backward``, ``step.memory.commit``, ``step.adam`` and
        ``step.stats``."""
        self.optimizer.zero_grad(set_to_none=True)
        mem_rows = lu_rows = embed = None
        if self.use_memory:
            mem_rows, lu_rows = self._apply_mail(pack)
        with span("step.embed"):
            if self.pairs:
                pos, neg = self._score_pairs(pack, train=True)
                loss = pair_bce_loss(pos, neg, pack.ev_valid)
            else:
                embed = self._embed(pack, mem_rows, lu_rows, train=True)
                pos, neg = arch_predict(self.model, embed, pack)
                loss = bce_loss(pos, neg, pack.ev_valid)
        with span("step.backward"):
            loss.backward()
        if self.use_memory:
            # after backward, since the state's tensors are written in
            # place; before the Adam step, since DyRep's mail reads the
            # step's parameters
            self._commit(pack, mem_rows, lu_rows, embed)
        with span("step.adam"):
            self.optimizer.step()
        loss = loss.detach()
        with span("step.stats"):
            acc = self._accumulate(acc, loss, pos.detach(), neg.detach(),
                                   pack.ev_valid)
        return loss, acc

    def _score_pairs(self, wire, train: bool):
        """DyGFormer's (pos (B,), neg (B, M)) logits of a device
        HistoryWire: the token grids of its pairs (``step.embed.pairs``),
        the encoder with the readout (``step.embed.encoder``), then the
        scorer.  In training the whole batch's pairs at once, with dropout
        from ``self.generator``; at eval ``EVAL_PAIRS`` pairs at a time."""
        B, E = wire.ev_end.shape
        rows = B if train else max(1, EVAL_PAIRS // (E - 1))
        pos, neg = [], []
        for r0 in range(0, B, rows):
            part = wire if rows >= B else type(wire)(
                *(f[r0:r0 + rows] for f in wire))
            with span("step.embed.pairs"):
                tokens = pair_tokens(self.model, part, self.node_feats,
                                     self.feats)
            with span("step.embed.encoder"):
                h_u, h_v = encode_pairs(self.model, tokens, train,
                                        self.generator if train else None)
            p, n = split_logits(self.model.pred(h_u, h_v),
                                part.ev_end.shape[0])
            pos.append(p)
            neg.append(n)
        if len(pos) == 1:
            return pos[0], neg[0]
        return torch.cat(pos), torch.cat(neg)

    @staticmethod
    @torch.no_grad()
    def _accumulate(acc, loss, pos, neg, valid):
        """``acc`` + [loss · n, AP, AUC, 1] of one step over its ``valid``
        events (tgb_tgn_dgl_tpu engine/train.py:369-379)."""
        neg1 = neg if neg.dim() == 1 else neg[:, 0]
        ap, auc = ap_auc(torch.sigmoid(pos), torch.sigmoid(neg1), valid)
        return acc + torch.stack([loss * valid.sum(), ap, auc,
                                  torch.ones((), device=acc.device)])

    def train_epoch(self) -> Dict[str, float]:
        """One pass over the train split (or its first
        ``train.sanity_batches`` batches; a batch past that limit is not
        packed, so the stream state stops where training stopped).
        Returns loss (Σ loss·n, as the JAX engine reports it), mean AP,
        mean AUC and the number of events.  ``last_epoch_trace`` holds
        ``pack_s``, the time this thread spent getting each next device
        wire (the wait for the packer, the submit of the next batch, the
        copy's enqueue), its parts ``fetch_s`` in the packer's fetch (at
        gnn.layer > 1 the whole pack, on this thread) and ``copy_s`` in
        ``wire_to_device``, and ``disp_s``, the time it spent dispatching
        the expansion and the train step (in device-cache mode the
        advance of the resident state too); and ``spans``, every span's
        ``s``, ``self_s`` and ``n`` (``SectionTimers.summary``): ``feed``
        (``pack_s``) with ``feed.fetch`` and ``feed.copy``, and ``step``
        (``disp_s``) with ``step.expand``, the train step's parts
        (``_train_step``) and ``step.advance``; and ``gather_launches``,
        the launches of the memory-row gather's backward kernel
        (``ops/gather.py``: one a gather, two a memory step on CUDA, none
        on the CPU).  DyGFormer's trace adds ``pairs``, the encoder
        passes of the epoch (padded pairs included), and
        ``history_filled``, the share of the real ends' history places
        that held an interaction."""
        self.packer.reset_cache()
        if self.device_cache:
            self.sstate = reset_stream_cache(self.sstate)
        if self.use_memory:
            # memory and cache reset together (pyg_epoch_utils.py:11-16)
            self.mem_state = self._fresh_memory_state()
        acc = torch.zeros(4, dtype=torch.float32, device=self.device)
        total = nb = pairs = filled = places = 0
        timers = SectionTimers()
        launches0 = gather.launches()
        t0 = time.perf_counter()
        with timers.install():
            wires = self._packed(self._train_jobs(),
                                 self._train_nb_bucket() if self.train_lean
                                 else 0)
            while True:
                with span("feed"):
                    nxt = next(wires, None)
                    if nxt is not None:
                        (lo, hi), (wire, iw) = nxt
                        if self.pairs:
                            n_ends = wire.hist_len[:hi - lo]
                            pairs += (wire.ev_end.shape[0]
                                      * (wire.ev_end.shape[1] - 1))
                            filled += int(n_ends.sum())
                            places += n_ends.size * wire.hist_nid.shape[2]
                        with span("feed.copy"):
                            wire = wire_to_device(wire, self.device)
                if nxt is None:
                    break
                with span("step"):
                    with span("step.expand"):
                        pack = self._expand(wire, iw)
                    _, acc = self._train_step(pack, acc)
                    if self.device_cache:
                        with span("step.advance"):
                            self._advance(wire, eval_mode=False)
                nb += 1
                self._step += 1
                total += hi - lo
        vals = acc.cpu().numpy()                    # ONE fetch
        self.last_epoch_trace = {"total_s": time.perf_counter() - t0,
                                 **_trace_keys(timers), "batches": nb,
                                 "gather_launches":
                                     gather.launches() - launches0}
        if self.pairs:
            self.last_epoch_trace.update(
                pairs=pairs, history_filled=filled / max(places, 1))
        n = max(float(vals[3]), 1.0)
        return {"loss": float(vals[0]), "ap": float(vals[1] / n),
                "auc": float(vals[2] / n), "events": total}

    # --------------------------------------------------------------- eval
    def _finalize(self, acc, opt, pes, valid):
        """The batch's mean metric over its real events, added to the
        running [Σ batch mean, batches] accumulator (tgb_tgn_dgl_tpu
        engine/train.py:650-655)."""
        kind, k = parse_eval_metric(self.data.eval_metric)
        val = torch.where(valid, rank_metric_from_counts(opt, pes, kind, k),
                          0.0)
        batch_mean = val.sum() / torch.clamp(valid.sum(), min=1)
        return acc + torch.stack([batch_mean,
                                  torch.ones((), device=acc.device)])

    def _score_counts(self, embed, pack, opt, pes, neg_mask):
        """Edge scoring into per-event rank counts (tgb_tgn_dgl_tpu
        engine/train.py:623-643).  ``neg_mask`` (B, Mc) marks the real
        negative columns in pad+mask mode, else None."""
        pos, neg = arch_predict(self.model, embed, pack)
        return _rank_counts(pos, neg, opt, pes, neg_mask)

    # ------------------------------------------- slot-unique eval: the gate
    def _log_eval_gate(self, reason: str) -> None:
        """The column-chunk fallback is a several-fold slower eval: say
        which check closed the gate, once per (run, reason)."""
        if reason not in self._eval_gate_logged:
            self._eval_gate_logged.add(reason)
            print(f"[eval] slot-unique protocol off ({reason}); "
                  f"using the column-chunk protocol", flush=True)

    def _eval_unique_bucket(self, split: str) -> Optional[int]:
        """The block-id bucket of ``split``'s eval-lean wires where the
        slot-unique protocol can run, else None (tgb_tgn_dgl_tpu
        engine/train.py:693-752).  Only the checks that can fail in the
        port are kept: the dedup wire is always on at one layer outside
        device-cache mode, and slot-unique is taken whatever the dedup,
        with no knob to turn it off."""
        blocks = self.blocks_for(split)
        cap = self.config.train.max_intra_block
        t = self.data.t
        for ok, reason in (
                # a pair's score has no root slot to share
                (not self.pairs, PAIR_GATE),
                # the eval-lean dedup wire holds the cache's in-edges, not
                # the t-CSR's draws
                (not self.uniform, UNIFORM_GATE),
                # the lean wire is packed a chunk at a time against the
                # device's cache (tgb_tgn_dgl_tpu engine/train.py:699)
                (not self.device_cache, "device_cache mode"),
                # the eval-lean dedup wire carries no rslot, and a layer-2
                # root's sources may fall in another embed chunk
                (self.config.gnn.layer == 1, "gnn.layer>1"),
                # an intra window over 255 cannot take the dedup wire, and
                # this protocol cannot restart a half-streamed split with
                # another wire
                (cap is not None and cap <= 255,
                 "max_intra_block=None or >255"),
                # the device clock grid uses a -1 "no event" sentinel
                (len(t) == 0 or np.asarray(t).min() >= 0,
                 "negative event timestamps"),
                # the eval-lean wire's block id is u8 or u16
                (len(blocks) == 0 or int(blocks.max()) < 65536,
                 ">65536 dependency blocks in a batch")):
            if not ok:
                self._log_eval_gate(reason)
                return None
        return nb_bucket_of(blocks)

    # ----------------------------------------- slot-unique eval: the pass
    # The column-chunk protocol embeds each (node, block) root once per
    # negative chunk.  A root slot's embedding depends only on its (node,
    # block) pair (cache row, eval clock, intra window), so packing the
    # batch once with all M negatives dedups each block's roots to the
    # unique candidates, and ranks come from gathers into one table: the
    # same embeddings, the same predictor math, and integer rank counts
    # that add up over any column partition (tgb_tgn_dgl_tpu
    # engine/train.py:663-680).
    def _unique_jobs(self, split: str, fixed: FixedNegatives):
        """One full-M job per batch; meta = (lo, hi, blk, M, qmask), the
        stream state advanced by the batch (insert and write_mail at
        their defaults)."""
        d = self.data
        for lo, hi, rows, blk in self._iter_batches(split):
            neg, qmask = fixed.query_batch(lo, hi)
            neg2d = np.asarray(neg).reshape(len(rows), -1)
            yield ((lo, hi, blk, neg2d.shape[1], qmask),
                   (d.src[rows], d.dst[rows], d.t[rows], rows, blk, neg2d),
                   dict(eval_mode=True))

    def _eval_unique_batches(self, split: str, fixed: FixedNegatives,
                             B: int, nb_bucket: int):
        """Yields ((lo, hi, iw, n_chunks, n_mc), wire, mask) per batch, the
        host half of tgb_tgn_dgl_tpu engine/train.py:880-968: the packer
        runs one batch ahead (``_packed``); each wire goes eval-lean, its
        root-slot fields padded to ``n_chunks`` equal embed chunks of at
        most ``EVAL_UNIQUE_SLOTS`` slots (pad root_loc = Ub-1, the rest 0),
        its negative slots to ``n_mc`` columns chunks of 256, and ``mask``
        (B, 256·n_mc) marks the real (event, negative) pairs, AND-ed with
        the pad+mask validity."""
        for (lo, hi, blk, M, qmask), (wire, iw) in self._packed(
                self._unique_jobs(split, fixed)):
            if not isinstance(wire, DedupWire):
                # the gate keeps the intra window within 255, so a batch
                # the packer handed back means the gate and the packer
                # disagree: fail rather than go on with another wire
                raise RuntimeError(
                    "slot-unique eval: dedup pack unrepresentable "
                    "mid-split; set train.max_intra_block<=255")
            wire = eval_lean_dedup(wire, blk, nb_bucket)
            if wire.cache_dt is not None:
                raise RuntimeError(
                    "slot-unique eval requires the lean wire (block "
                    "count or negative timestamps rejected it)")
            R = wire.root_loc.shape[0]
            n_chunks = max(1, -(-R // EVAL_UNIQUE_SLOTS))
            m = self._root_multiple
            R2 = n_chunks * m * -(-R // (n_chunks * m))
            if R2 != R:
                pads = {"root_loc": wire.uniq_nid.shape[0] - 1, "root_cr": 0,
                        "intra_lo": 0, "intra_cnt": 0, "intra_start": 0,
                        "root_blk": 0}
                wire = wire._replace(**{
                    f: np.concatenate([getattr(wire, f),
                                       np.full(R2 - R, v,
                                               getattr(wire, f).dtype)])
                    for f, v in pads.items()})
            n_mc = max(1, -(-M // EVAL_SCORE_COLUMNS))
            Mp = n_mc * EVAL_SCORE_COLUMNS
            braw = hi - lo
            mask = np.zeros((B, Mp), bool)
            mask[:braw, :M] = True
            if qmask is not None:            # pad+mask ragged negatives
                mask[:braw, :M] &= np.asarray(qmask, bool)
            ns = np.asarray(wire.ev_neg_slot).reshape(B, -1)
            if Mp != M:
                ns = np.concatenate([ns, np.zeros((B, Mp - M), ns.dtype)],
                                    axis=1)
            yield ((lo, hi, iw, n_chunks, n_mc),
                   wire._replace(ev_neg_slot=ns), mask)

    def _unique_eval_step(self, wire, iw, mask, valid, acc,
                          n_chunks: int, n_mc: int):
        """One batch of slot-unique eval on the device (tgb_tgn_dgl_tpu
        engine/train.py:754-878, its scans as loops over host counts):
        embed the root slots chunk by chunk into one (R2, D) table, score
        every event against its negatives in column chunks by gathers into
        it, and add the batch's mean metric to ``acc``.  With the memory,
        the mail is applied once on the batch's read set before the first
        embedding, and committed with the batch's write plan after
        scoring (DyRep's mail from the whole table, through the full (R2,)
        slot map: the first chunk's expansion holds only its own slots).
        The table is in the compute dtype (tgb_tgn_dgl_tpu
        engine/train.py:813): each chunk's fp32 embedding is rounded into
        it."""
        R2 = wire.root_loc.shape[0]
        Rc = R2 // n_chunks
        emb = torch.empty((R2, self.model_cfg.hidden_dim),
                          dtype=self.model_cfg.compute_dtype,
                          device=self.device)
        mem_rows = lu_rows = None
        for c in range(n_chunks):
            rows = slice(c * Rc, (c + 1) * Rc)
            with span("step.expand"):
                pack = self._expand(wire._replace(**{
                    f: getattr(wire, f)[rows] for f in SLOT_FIELDS}), iw)
            if c == 0:
                # the chunk-independent parts (read set, write plan) are
                # the same in every chunk's expansion
                pack0 = pack
                if self.use_memory:
                    mem_rows, lu_rows = self._apply_mail(pack0)
            with span("step.embed"):
                emb[rows] = self._embed(pack, mem_rows, lu_rows,
                                        train=False)
        with span("step.score"):
            opt, pes = self._unique_counts(emb, wire, mask, n_mc)
            acc = self._finalize(acc, opt, pes, valid)
        if self.use_memory:
            self._commit(pack0._replace(root_loc=wire.root_loc), mem_rows,
                         lu_rows, emb)
        return acc

    def _unique_counts(self, emb, wire, mask, n_mc: int):
        """The (B,) rank counts of a slot-unique batch from its embedding
        table, by gathers, ``n_mc`` column chunks of its negative slots.
        The gathered rows go to the fp32 predictor in fp32 (a bfloat16
        table's rows promote exactly, as in JAX)."""
        h_src = emb[wire.ev_src_slot.long()].float()
        h_pos = emb[wire.ev_pos_slot.long()].float()
        neg_slot = wire.ev_neg_slot.long()                    # (B, Mp)
        Mc = neg_slot.shape[1] // n_mc
        opt = pes = torch.zeros(neg_slot.shape[0], dtype=torch.int64,
                                device=self.device)
        for j in range(n_mc):
            cols = slice(j * Mc, (j + 1) * Mc)
            pos, neg = self.model.pred(h_src, h_pos,
                                       emb[neg_slot[:, cols]].float())
            p, m = pos[:, None], mask[:, cols]
            opt = opt + ((neg > p) & m).sum(dim=1)
            pes = pes + ((neg >= p) & m).sum(dim=1)
        return opt, pes

    # ------------------------------------------------ the eval pass itself
    def evaluate(self, split: str = "val") -> float:
        """Streaming TGB evaluation of ``split``, by the slot-unique
        protocol where its gate opens (the default, as in the JAX Engine),
        else by the column-chunk protocol (tgb_tgn_dgl_tpu
        engine/train.py:1892-1901).  Both give the same ranks and leave
        the same stream state.  ``last_eval_trace`` holds ``protocol``,
        ``pack_s`` (getting each next device wire, with its parts
        ``fetch_s`` and ``copy_s``), ``disp_s``, ``batches``,
        ``embed_chunks`` and ``score_chunks``, ``chunks``, the
        embedding's launches (``embed_chunks``), and ``spans``, as
        ``last_epoch_trace`` has them: ``step`` (``disp_s``) holds
        ``step.expand``, ``step.memory.apply``, ``step.embed``,
        ``step.score``, ``step.memory.commit`` and ``step.advance``
        (``step.expand`` and ``step.embed`` once an embed chunk)."""
        nb_bucket = self._eval_unique_bucket(split)
        if nb_bucket is None:
            return self._evaluate_chunked(split)
        return self._evaluate_unique(split, nb_bucket)

    def _fixed_negatives(self, split: str) -> FixedNegatives:
        ns = self.data.val_ns if split == "val" else self.data.test_ns
        if ns is None:
            raise ValueError(f"no fixed negatives for split '{split}'")
        return FixedNegatives(ns, mode=self.config.train.eval_neg_mode)

    def _evaluate_unique(self, split: str, nb_bucket: int) -> float:
        """The slot-unique pass (tgb_tgn_dgl_tpu engine/train.py:970-993):
        one ``_unique_eval_step`` a batch."""
        fixed = self._fixed_negatives(split)
        B = self.config.train.batch_size
        ar = torch.arange(B, device=self.device)
        n = {"batches": 0, "embed_chunks": 0, "score_chunks": 0}

        def dispatch(meta, wire, mask, acc):
            lo, hi, iw, n_chunks, n_mc = meta
            n["batches"] += 1
            n["embed_chunks"] += n_chunks
            n["score_chunks"] += n_mc
            return self._unique_eval_step(wire, iw, mask, ar < (hi - lo),
                                          acc, n_chunks, n_mc)

        return self._eval_pass(
            "slot_unique", self._eval_unique_batches(split, fixed, B,
                                                     nb_bucket), dispatch, n)

    def _evaluate_chunked(self, split: str) -> float:
        """The column-chunk pass (tgb_tgn_dgl_tpu engine/train.py:1599-1627):
        each batch's fixed negatives go through the model in chunks of
        ``eval_neg_chunk_size``; ranks add up across chunks, and only the
        LAST chunk of a batch inserts the batch into the stream state (in
        device-cache mode, the advance of the resident state:
        tgb_tgn_dgl_tpu engine/train.py:1130-1152).
        ``evaluate`` takes it where the slot-unique gate closes; the tests
        and chip_smoke.py call it to hold the two protocols together."""
        fixed = self._fixed_negatives(split)
        B = self.config.train.batch_size
        ar = torch.arange(B, device=self.device)
        n = {"batches": 0, "embed_chunks": 0, "score_chunks": 0}
        # the eval-lean clock grid's block width, fixed for the pass
        nb_bucket = nb_bucket_of(self.blocks_for(split))
        counts = {}

        def items():
            for meta, (wire, iw) in self._packed(
                    self._eval_jobs(split, fixed, B)):
                lo, hi, blk, first, last, mask_c = meta
                if isinstance(wire, DedupWire):
                    wire = eval_lean_dedup(wire, blk, nb_bucket)
                yield (lo, hi, iw, first, last), wire, mask_c

        def dispatch(meta, wire, mask_c, acc):
            lo, hi, iw, first, last = meta
            if first:
                counts["opt"] = counts["pes"] = torch.zeros(
                    B, dtype=torch.int64, device=self.device)
            with span("step.expand"):
                pack = (self._expand_lean(wire, iw, eval_mode=True)
                        if self.device_cache else self._expand(wire, iw))
            if self.pairs:
                with span("step.embed"):
                    pos, neg = self._score_pairs(pack, train=False)
            else:
                mem_rows = lu_rows = None
                if self.use_memory:
                    # applied mail is cleared by the commit, so applying
                    # and committing on every chunk is idempotent; only the
                    # last chunk carries a write plan
                    mem_rows, lu_rows = self._apply_mail(pack)
                with span("step.embed"):
                    embed = self._embed(pack, mem_rows, lu_rows,
                                        train=False)
                if self.use_memory:
                    self._commit(pack, mem_rows, lu_rows, embed)
                if last and self.device_cache:
                    with span("step.advance"):
                        self._advance(wire, eval_mode=True)
            with span("step.score"):
                counts["opt"], counts["pes"] = (
                    _rank_counts(pos, neg, counts["opt"], counts["pes"],
                                 mask_c) if self.pairs else
                    self._score_counts(embed, pack, counts["opt"],
                                       counts["pes"], mask_c))
                if last:
                    acc = self._finalize(acc, counts["opt"], counts["pes"],
                                         ar < (hi - lo))
            n["embed_chunks"] += 1
            n["score_chunks"] += 1
            if last:
                n["batches"] += 1
            return acc

        return self._eval_pass("column_chunk", items(), dispatch, n)

    @torch.no_grad()
    def _eval_pass(self, protocol: str, items, dispatch, n) -> float:
        """The loop both protocols share: ``items`` yields (meta, host
        wire, host mask or None), in the ``feed`` span; each wire crosses
        with its mask in one staging buffer and copy, ``dispatch`` adds to
        the device accumulator in the ``step`` span, and the pass fetches
        it once."""
        acc = torch.zeros(2, dtype=torch.float32, device=self.device)
        timers = SectionTimers()
        t0 = time.perf_counter()
        with timers.install():
            while True:
                with span("feed"):
                    nxt = next(items, None)
                    if nxt is not None:
                        meta, wire, mask = nxt
                        with span("feed.copy"):
                            wire, mask = wire_to_device(wire, self.device,
                                                        mask)
                if nxt is None:
                    break
                with span("step"):
                    acc = dispatch(meta, wire, mask, acc)
        vals = acc.cpu().numpy()                    # ONE fetch
        self.last_eval_trace = {"total_s": time.perf_counter() - t0,
                                **_trace_keys(timers), "protocol": protocol,
                                **n, "chunks": n["embed_chunks"]}
        return float(vals[0] / max(float(vals[1]), 1.0))

    # --------------------------------------------------- bucket pre-warming
    def warm_buckets(self, n_batches: int = 96, eval_batches: int = 8) -> None:
        """Seed the packer's sticky shape buckets with the maxima that the
        first ``n_batches`` train batches, and the first ``eval_batches``
        val batches under the protocol ``evaluate`` will take, reach in a
        throwaway packer (tgb_tgn_dgl_tpu engine/train.py:1348-1462).  The
        JAX Engine does it to compile once a profile; here it fixes the
        padded shapes a run packs at from its first batch, so that ``fit``
        pads (and, on the GPU, sums) as the JAX ``fit`` does, and so that
        the ranges of a multi-host super-batch share their buckets
        (parallel/multihost.py::concat_offset_wires).  The stream and the
        negative sampler are untouched: the probe packs from a sampler of
        its own with the same seed.  The merge is a monotone max, so a
        table loaded from a checkpoint, which warming made, stays as it
        is."""
        d = self.data
        if self.pairs:
            # a history wire's shapes are the batch's: nothing to seed
            return
        if self.uniform:
            # the engine's t-CSR (read only) and a same-seed rng of the
            # probe's own: it replays the first epoch's draws and leaves
            # the engine's untouched (tgb_tgn_dgl_tpu engine/train.py:
            # 1385-1392)
            probe = StreamPacker(d.num_nodes, self.packer.cfg)
            probe.set_tcsr(self.packer._tcsr)
        else:
            probe = (NativeLeanPacker if self.device_cache
                     else NativeStreamPacker)(d.num_nodes, self.packer.cfg)
        # the JAX Engine's _wire_dedup: the dedup wire where the port ships
        # it, else the wire its engine packs
        dedup = not self._sync_pack

        def pack(args, kw):
            if dedup and probe.pack_wire_dedup(*args, **kw) is not None:
                return
            probe.pack_wire(*args, **kw)

        neg_probe = NegLinkSamplerDest(d.unique_dst(),
                                       seed=self.config.train.seed)
        for _, _, rows, blk in itertools.islice(self._iter_batches("train"),
                                                n_batches):
            dst = d.dst[rows]
            pack((d.src[rows], dst, d.t[rows], rows, blk,
                  neg_probe.sample(dst)), {})
        if eval_batches and d.val_ns is not None:
            fixed = self._fixed_negatives("val")
            unique = self._eval_unique_bucket("val") is not None
            for lo, hi, rows, blk in itertools.islice(
                    self._iter_batches("val"), eval_batches):
                neg, _ = fixed.query_batch(lo, hi)
                neg2d = np.asarray(neg).reshape(len(rows), -1)
                args = (d.src[rows], d.dst[rows], d.t[rows], rows, blk)
                if unique:
                    pack((*args, neg2d), dict(eval_mode=True))
                    continue
                M = neg2d.shape[1]
                Mc = eval_neg_chunk_size(self.config, M, hi - lo)
                n_chunks = -(-M // Mc)
                for ci in range(n_chunks):
                    last = ci == n_chunks - 1
                    pack((*args, neg2d[:, ci * Mc:(ci + 1) * Mc]),
                         dict(eval_mode=True, insert=last, write_mail=last))
        for key, names in probe._sticky.items():
            for name, val in names.items():
                self.packer._sticky_bucket(key, name, val)

    # ------------------------------------------------------- the epoch loop
    def fit(self, epochs: Optional[int] = None, log=print,
            eval_every: int = 1,
            early_stop: Optional[EarlyStopMonitor] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 0,
            log_dir: Optional[str] = None,
            val_snapshot: bool = False) -> Dict[str, list]:
        """Epoch loop mirroring tgb_tgn_dgl_tpu engine/train.py:2010-2081
        (reference pyg-mem-tgn.py:53-67): ``epochs`` more epochs, the
        config's count when None, none when 0 (the JAX ``fit`` reads 0 as
        None), a val pass after every ``eval_every``-th; labels and
        checkpoint names continue from ``_epoch``.
        Besides the JAX events, ``metrics.jsonl`` gets a ``checkpoint``
        event with the file's bytes and the save's seconds."""
        metrics = MetricsLogger(log_dir)
        if not self._warmed:
            self.warm_buckets()
            self._warmed = True
        if epochs is None:
            epochs = self.config.train.epoch
        history = {"loss": [], "val": [], "train_s": [], "val_s": []}
        start = time.time()
        e0 = self._epoch
        try:
            for e in range(e0, e0 + epochs):
                t0 = time.time()
                stats = self.train_epoch()      # ends on its metrics fetch
                self._epoch = e + 1
                t1 = time.time()
                log(f"Epoch: {e + 1:02d}, Loss: {stats['loss']:.4f}, "
                    f"AP: {stats['ap']:.4f}, AUC: {stats['auc']:.4f}, "
                    f"Training elapsed Time (s): {t1 - t0: .4f}")
                history["loss"].append(stats["loss"])
                history["train_s"].append(t1 - t0)
                metrics.log("train_epoch", epoch=e + 1, loss=stats["loss"],
                            ap=stats["ap"], auc=stats["auc"],
                            events=stats["events"], seconds=round(t1 - t0, 4),
                            events_per_s=round(stats["events"]
                                               / max(t1 - t0, 1e-9), 1))
                val = None
                if (e + 1) % eval_every == 0 and self.data.val_ns is not None:
                    t0 = time.time()
                    # val_snapshot keeps the streaming eval's state changes
                    # (clocks, cache, memory advance through val in the
                    # reference protocol) out of training
                    snap = self.snapshot_stream() if val_snapshot else None
                    val = self.evaluate("val")
                    if snap is not None:
                        self.restore_stream(snap)
                    t1 = time.time()
                    log(f"Validation {self.data.eval_metric}: {val: .4f}, "
                        f"elapsed Time (s): {t1 - t0: .4f}")
                    history["val"].append(val)
                    history["val_s"].append(t1 - t0)
                    metrics.log("val", epoch=e + 1,
                                metric=self.data.eval_metric, value=val,
                                seconds=round(t1 - t0, 4))
                if checkpoint_dir and checkpoint_every \
                        and (e + 1) % checkpoint_every == 0:
                    path = os.path.join(
                        checkpoint_dir,
                        f"ckpt_epoch{e + 1:04d}{CHECKPOINT_SUFFIX}")
                    t0 = time.time()
                    nbytes = self.save_checkpoint(path)
                    metrics.log("checkpoint", epoch=e + 1, path=path,
                                bytes=nbytes,
                                seconds=round(time.time() - t0, 4))
                if early_stop is not None and val is not None:
                    if early_stop.step_check(val, self._model_state()):
                        log(f"INFO: early stopping at epoch {e + 1} "
                            f"(best epoch {early_stop.best_epoch})")
                        if early_stop.best_path:
                            self._restore_model_state(early_stop.load_best(
                                self._model_state(), self.device))
                        break
            log(f"Execution Time: {time.time() - start:.6f} seconds")
        finally:
            metrics.close()
        return history

    # ---------------------------------------------------- stream snapshots
    def snapshot_stream(self):
        """A copy of the whole stream state: the packer's (cache, clocks,
        mail ring pointers, event cursor; in device-cache mode its ring
        pointers and the device's ``sstate``) and the memory's
        (tgb_tgn_dgl_tpu engine/train.py:2084-2104).  Taken around a val
        pass it keeps the streaming eval's changes out of training (the
        reference's unwired backup_memory/restore_memory,
        model_utils.py:290-308).  Under 'uniform' the packer's ``_rng``
        is not in it, as in JAX: the val pass's draws are not rewound."""
        snap = {"packer": self.packer.snapshot()}
        if self.device_cache:
            snap["sstate"] = clone_stream_state(self.sstate)
        if self.use_memory:
            snap["mem_state"] = _clone_state(self.mem_state)
        return snap

    def restore_stream(self, snap) -> None:
        """Restore a ``snapshot_stream`` copy; the snapshot stays valid
        (the memory is cloned again: later commits write in place)."""
        self.packer.restore(snap["packer"])
        if self.device_cache:
            self.sstate = clone_stream_state(snap["sstate"])
        if self.use_memory:
            self.mem_state = _clone_state(snap["mem_state"])

    # ------------------------------------------------------- checkpointing
    def _model_state(self):
        """The learnable state only (the reference monitor checkpoints
        model state_dicts, modules/early_stopping.py:68-77)."""
        return {"params": self.model.state_dict()}

    def _restore_model_state(self, state) -> None:
        self.model.load_state_dict(state["params"])

    def _full_state(self):
        """Everything a run resumes from exactly (tgb_tgn_dgl_tpu
        engine/train.py:2117-2145): the parameters, Adam's state, the
        dropout generator's state and its device type, the negative
        sampler's PCG64 state (hi/lo words as int64), the cursors, the
        packer's state with its sticky shape buckets and, under 'uniform',
        its ``_rng`` state (both of which the JAX checkpoint leaves out)
        and the memory's.  In device-cache mode the
        packer's state is its ring pointers, and the device's ``sstate``
        is kept beside it (:2130-2133), the lean packer's buckets too."""
        opt = self.optimizer.state_dict()
        # Adam makes its moments at a parameter's first step; until then
        # they are written as the zeros it starts from, so that every
        # checkpoint has the same keys and shapes
        for i, p in enumerate(self.model.parameters()):
            opt["state"].setdefault(i, {
                "step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)})
        st = {
            "params": self.model.state_dict(),
            "optimizer": opt,
            "generator": self.generator.get_state(),
            "generator_device": self.generator.device.type,
            "neg_rng": torch.from_numpy(
                rng_state_to_array(self.neg_sampler.rng).view(np.int64)),
            "step": self._step,
            "epoch": self._epoch,
            # the padded sizes the next packs start from: a resumed run
            # pads (and so sums, on the GPU) as this run would
            "packer": {"buckets": self.packer.bucket_state()},
        }
        if self.device_cache:
            (ptr,) = self.packer.snapshot()
            st["packer"]["mail_ptr"] = torch.from_numpy(ptr)
            st["sstate"] = dict(zip(self.sstate.cache._fields,
                                    self.sstate.cache),
                                clock=self.sstate.clock)
        else:
            nbr, eid, t, clock, cur, ptr = self.packer.snapshot()
            st["packer"].update(
                cache_nbr=torch.from_numpy(nbr),
                cache_eid=torch.from_numpy(eid),
                cache_t=torch.from_numpy(t),
                clock=torch.from_numpy(clock), cur_e_id=int(cur),
                mail_ptr=torch.from_numpy(ptr))
        if self.uniform:
            # the draws a resumed run makes next
            st["packer"]["rng"] = torch.from_numpy(
                rng_state_to_array(self.packer._rng).view(np.int64))
        if self.use_memory:
            st["mem_state"] = dict(zip(self.mem_state._fields,
                                       self.mem_state))
        return st

    def save_checkpoint(self, path: str) -> int:
        """Write the full state to ``path``; returns the file's bytes."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_state(path, self._full_state())
        return os.path.getsize(path)

    def load_checkpoint(self, path: str):
        """Restore a ``save_checkpoint`` file and return its tree.  A
        missing key or a shape that differs raises and names it; a
        generator state from another device type raises ValueError (the
        CUDA Philox state and the CPU Mersenne Twister state cannot stand
        in for each other)."""
        template = self._full_state()
        # its size is the device type's: the type is checked first, below
        del template["generator"]
        # the file's buckets replace the engine's whole: a key that this
        # engine has packed (an eval's, say) is not asked of the file
        del template["packer"]["buckets"]
        st = load_state(path, template, self.device)
        mine = self.generator.device.type
        if st["generator_device"] != mine:
            raise ValueError(
                f"checkpoint {path} holds a {st['generator_device']} "
                f"generator state; this engine's generator is on {mine}")
        self.generator.set_state(st["generator"].cpu())
        self.model.load_state_dict(st["params"])
        opt = st["optimizer"]
        for s in opt["state"].values():
            # Adam keeps its step counts on the host, as a fresh optimizer
            s["step"] = s["step"].cpu()
        self.optimizer.load_state_dict(opt)
        self.neg_sampler.rng = rng_state_from_array(
            st["neg_rng"].cpu().numpy().view(np.uint64))
        self._step = int(st["step"])
        self._epoch = int(st["epoch"])
        pk = st["packer"]
        if self.device_cache:
            self.packer.restore((pk["mail_ptr"].cpu().numpy(),))
            ss = st["sstate"]
            self.sstate = type(self.sstate)(
                cache=NeighborCacheState(**{f: ss[f] for f in
                                            NeighborCacheState._fields}),
                clock=ss["clock"])
        else:
            nbr, eid, t, clock, ptr = (pk[k].cpu().numpy() for k in (
                "cache_nbr", "cache_eid", "cache_t", "clock", "mail_ptr"))
            self.packer.restore((nbr, eid, t, clock, int(pk["cur_e_id"]),
                                 ptr))
        if self.uniform:
            self.packer._rng = rng_state_from_array(
                pk["rng"].cpu().numpy().view(np.uint64))
        self.packer.load_bucket_state(pk["buckets"])
        if self.use_memory:
            self.mem_state = type(self.mem_state)(**st["mem_state"])
        return st


def _trace_keys(timers: SectionTimers) -> Dict[str, object]:
    """The span sums an epoch's or a pass's trace has always had, under
    their old names, and every span."""
    return {"pack_s": timers.seconds("feed"), "disp_s": timers.seconds("step"),
            "fetch_s": timers.seconds("feed.fetch"),
            "copy_s": timers.seconds("feed.copy"),
            "spans": timers.summary()}


def _rank_counts(pos, neg, opt, pes, neg_mask):
    """``opt`` / ``pes`` plus each event's negatives scored above / at or
    above its positive; ``neg_mask`` (B, Mc) marks the real negative
    columns in pad+mask mode, else None."""
    neg2 = neg if neg.dim() == 2 else neg[:, None]
    p = pos[:, None]
    gt = neg2 > p
    ge = neg2 >= p
    if neg_mask is not None:
        gt = gt & neg_mask
        ge = ge & neg_mask
    return opt + gt.sum(dim=1), pes + ge.sum(dim=1)


def _clone_state(state):
    """A copy of a memory state NamedTuple, tensor by tensor."""
    return type(state)(*(t.clone() for t in state))
