"""ShardedEngine: the epoch loop over a (dp, state) mesh of processes on
torch.distributed, the port's counterpart of
tgb_tgn_dgl_tpu/parallel/engine.py.

The JAX engine jits its steps over a device mesh and lets GSPMD derive
the collectives from the layout (its docstring, :1-37).  The layout here
is the same, and its collectives are written out (parallel/mesh.py,
parallel/sharded.py):

  * every rank packs the same stream with its own packer (the packer
    state is a pure function of the stream: a JAX multi-process run's
    process-local data) and expands the whole wire with the inherited
    transport (dedup wire, packer one batch ahead);
  * rank (d, s) embeds its dp share of the root slots, the (R, D) table
    is all-gathered over dp (backward: reduce-scatter), and it scores its
    dp share of the events; the BCE takes the batch's global valid count
    as its denominators, so the shares' losses sum to the serial loss;
    every gradient is all-reduced over dp before Adam, and parameters and
    Adam's state stay replicated; the loss, AP and AUC come from the
    all-gathered, detached scores, so the accumulator is the serial one;
  * the memory (``MemoryState``) is row-sharded over "state": the read
    set is gathered over the state group before ``apply_mail`` (which then
    runs on every rank), and the commit writes the rows the shard owns;
  * dropout masks come from a generator seeded by (train.seed, d): ranks
    of one dp index draw the same masks; at dp = 1 it is the serial
    Engine's generator, so a world of one is the serial Engine bit for bit;
  * eval splits every embed chunk (slot-unique, or a column chunk) over dp
    by root rows, gathers the table, and all-gathers the rank counts of
    the dp shares of events before the metric, so the MRR is computed
    from the serial integers.  Every rank holds the whole eval wire.

``fit`` logs, writes ``metrics.jsonl``, checkpoints and ``model_best.pt``
on rank 0 alone; the val MRR is the same on every rank, so every rank
takes the same early-stop decision.  A checkpoint is one file by rank 0,
the gathered full state in the serial Engine's layout plus every dp
index's dropout generator; each rank loads its shard.

Refused (ValueError): arch 'dyrep' (its eager state is not sharded, as in
JAX), ``gnn.layer`` > 1 (JAX builds one layer whatever the config says;
layer-2 rslot reads would need a gather between layers),
``train.device_cache`` and ``train.wire_train_lean`` (the JAX sharded
engine turns the first off and never reads the second), no
``max_intra_block``, a batch size not divisible by dp, and dp not a power
of two up to 16 (root buckets are multiples of 16).  The port has no
fused dispatch (``fuse_steps``) and no ``wire_compact`` knob, so the JAX
engine's fused path has no counterpart.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..engine.checkpoint import EarlyStopMonitor, save_state
from ..engine.train import Engine, resolve_device
from ..models.factory import arch_predict
from ..models.memory import apply_mail
from ..models.tgnn import bce_loss
from ..utils.config import FrameworkConfig
from .mesh import Mesh, gather_rows, make_mesh
from .sharded import (RowShard, commit_owned, event_share, gather_state,
                      init_sharded_memory_state, read_for_apply, root_share,
                      shard_state)

# the dropout generator of dp index d is seeded train.seed + 1 + d·stride
# (d = 0: the serial Engine's seed)
DP_SEED_STRIDE = 1_000_003


def check_sharded(config: FrameworkConfig, dp: int) -> None:
    """Raise ValueError for what the sharded engine does not run."""
    tr, g = config.train, config.gnn
    if g.arch == "dyrep":
        raise ValueError("ShardedEngine does not support arch='dyrep' (its "
                         "eager mail state is not sharded); use Engine or "
                         "MultiHostEngine for DyRep")
    if g.layer != 1:
        raise ValueError(f"ShardedEngine runs one attention layer, not "
                         f"gnn.layer={g.layer}")
    if tr.device_cache or tr.wire_train_lean:
        raise ValueError("ShardedEngine ships the host packer's dedup wire: "
                         "train.device_cache and train.wire_train_lean are "
                         "not supported")
    if config.sampling.strategy != "recent":
        # the JAX ShardedEngine's packer gets no t-CSR (tgb_tgn_dgl_tpu
        # parallel/engine.py:133), so it samples from the recency cache
        # whatever the strategy says
        raise ValueError("ShardedEngine samples the 'recent' strategy only "
                         "(the JAX sharded engine attaches no t-CSR, so "
                         "'uniform' there is 'recent'); use Engine for "
                         "sampling.strategy 'uniform'")
    if tr.max_intra_block is None:
        raise ValueError("ShardedEngine needs a fixed train.max_intra_block")
    if tr.batch_size % dp:
        raise ValueError(f"train.batch_size ({tr.batch_size}) must be "
                         f"divisible by the mesh dp width ({dp})")
    if not (1 <= dp <= 16 and dp & (dp - 1) == 0):
        raise ValueError(f"dp width {dp} must be a power of two <= 16 "
                         f"(shape buckets are 16-divisible)")


def _place(full: torch.Tensor, sl: slice, part: torch.Tensor):
    """``full`` with its rows ``sl`` replaced by ``part`` (a new tensor)."""
    return torch.cat([full[:sl.start], part, full[sl.stop:]])


class _HeldBest:
    """A rank > 0's view of the caller's early-stop monitor.  It steps that
    monitor, so its counters carry from one ``fit`` call to the next as
    rank 0's do, but writes no file: the best parameters are held on the
    engine, beside the monitor they belong to."""

    def __init__(self, monitor: EarlyStopMonitor, engine: "ShardedEngine"):
        self.monitor = monitor
        self.engine = engine

    @property
    def best_epoch(self) -> int:
        return self.monitor.best_epoch

    @property
    def best_path(self) -> Optional[str]:
        # rank 0 restores exactly when its monitor has a file to restore
        return self.monitor.best_path

    def step_check(self, curr_val: float, state=None) -> bool:
        m = self.monitor
        stop = m.step_check(curr_val)
        if state is not None and m.best_epoch == m.epoch_count:
            self.engine._held_best = (m, {
                "params": {k: v.detach().clone()
                           for k, v in state["params"].items()}})
        return stop

    def load_best(self, template, device="cpu"):
        held = self.engine._held_best
        assert held is not None and held[0] is self.monitor, \
            "no best parameters held for this monitor"
        return held[1]


class ShardedEngine(Engine):
    """The serial ``Engine`` over a (dp, state) mesh of ranks (module
    docstring).  ``mesh`` defaults to ``make_mesh()`` over the process
    group with gloo on the CPU and NCCL on the GPU; ``device=None`` means
    the GPU, as for ``Engine``."""

    def __init__(self, data, config: FrameworkConfig,
                 mesh: Optional[Mesh] = None, device=None):
        if mesh is None:
            mesh = make_mesh(backend="gloo" if resolve_device(device).type
                             == "cpu" else "nccl")
        check_sharded(config, mesh.dp)
        self.mesh = mesh
        self.shard = RowShard.of(data.num_nodes + 1, mesh)
        super().__init__(data, config, device=device)
        self._root_multiple = mesh.dp
        # rank > 0: (the caller's early-stop monitor, its best parameters)
        self._held_best = None
        if mesh.d:
            self.generator.manual_seed(config.train.seed + 1
                                       + mesh.d * DP_SEED_STRIDE)

    # ------------------------------------------------------------ memory
    def _fresh_memory_state(self):
        return init_sharded_memory_state(self.mem_cfg, self.shard,
                                         self.device)

    def _apply_mail(self, pack):
        state, nid = read_for_apply(self.mem_state, self.shard, self.mesh,
                                    pack.uniq_nid)
        return apply_mail(self.model.memory, self.mem_cfg, state, nid,
                          self.feats)

    def _commit(self, pack, mem_rows, lu_rows, embed=None) -> None:
        self.mem_state = commit_owned(
            self.mem_state, self.shard, pack.uniq_nid, mem_rows.detach(),
            lu_rows.detach(), pack.mw_node, pack.mw_slot, pack.mw_partner,
            pack.mw_t, pack.mw_eid)

    def full_memory_state(self):
        """The whole N+1-row ``MemoryState`` (a collective over the state
        group)."""
        return gather_state(self.mem_state, self.shard, self.mesh)

    # ------------------------------------------------------------- steps
    def _embed(self, pack, mem_rows, lu_rows, train: bool):
        """This rank's dp share of the root slots embedded, then the whole
        (R, D) table gathered over dp."""
        part = super()._embed(root_share(pack, self.mesh), mem_rows, lu_rows,
                              train)
        return gather_rows(part, self.mesh)

    def _train_step(self, pack, acc: torch.Tensor):
        """The serial step over the mesh: the event share's BCE over the
        batch's valid count, gradients summed over dp before Adam, the
        loss and the scores gathered for the accumulator."""
        mesh = self.mesh
        self.optimizer.zero_grad(set_to_none=True)
        mem_rows = lu_rows = None
        if self.use_memory:
            mem_rows, lu_rows = self._apply_mail(pack)
        embed = self._embed(pack, mem_rows, lu_rows, train=True)
        mine = event_share(pack, mesh)
        pos, neg = arch_predict(self.model, embed, mine)
        loss = bce_loss(pos, neg, mine.ev_valid, n_valid=pack.ev_valid.sum())
        loss.backward()
        self._sum_grads()
        if self.use_memory:
            self._commit(pack, mem_rows, lu_rows)
        self.optimizer.step()
        loss = mesh.all_reduce(loss.detach(), "dp")
        return loss, self._accumulate(
            acc, loss, mesh.all_gather(pos.detach(), "dp"),
            mesh.all_gather(neg.detach(), "dp"), pack.ev_valid)

    def _sum_grads(self) -> None:
        """Every gradient summed over dp, in one all-reduce."""
        if self.mesh.dp == 1:
            return
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        flat = self.mesh.all_reduce(torch.cat([g.reshape(-1)
                                               for g in grads]), "dp")
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    # -------------------------------------------------------------- eval
    def _score_counts(self, embed, pack, opt, pes, neg_mask):
        """The column-chunk counts of this rank's event share (the rest of
        ``opt``/``pes`` untouched)."""
        sl = self.mesh.share(opt.shape[0])
        o, p = super()._score_counts(
            embed, event_share(pack, self.mesh), opt[sl], pes[sl],
            None if neg_mask is None else neg_mask[sl])
        return _place(opt, sl, o), _place(pes, sl, p)

    def _unique_counts(self, emb, wire, mask, n_mc: int):
        """The slot-unique counts of this rank's event share, in (B,)
        tensors zero elsewhere."""
        B = mask.shape[0]
        sl = self.mesh.share(B)
        o, p = super()._unique_counts(emb, wire._replace(
            ev_src_slot=wire.ev_src_slot[sl],
            ev_pos_slot=wire.ev_pos_slot[sl],
            ev_neg_slot=wire.ev_neg_slot[sl]), mask[sl], n_mc)
        zero = torch.zeros(B, dtype=o.dtype, device=o.device)
        return _place(zero, sl, o), _place(zero, sl, p)

    def _finalize(self, acc, opt, pes, valid):
        """The serial metric from the counts of every event share,
        all-gathered over dp."""
        sl = self.mesh.share(opt.shape[0])
        return super()._finalize(acc, self.mesh.all_gather(opt[sl], "dp"),
                                 self.mesh.all_gather(pes[sl], "dp"), valid)

    # ------------------------------------------------------ the epoch loop
    def fit(self, epochs: Optional[int] = None, log=print,
            eval_every: int = 1,
            early_stop: Optional[EarlyStopMonitor] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 0,
            log_dir: Optional[str] = None,
            val_snapshot: bool = False):
        """``Engine.fit`` on every rank: rank 0 logs (each line tagged
        with the mesh, as JAX's ``[sharded {...}]``), writes the metrics
        and the best model; another rank logs nothing, steps the same
        monitor and holds its best parameters in memory.  Checkpoints
        gather on every rank and are written by rank 0."""
        if self.mesh.rank == 0:
            tag = f"[sharded {self.mesh.shape}] "
            return super().fit(epochs, lambda msg: log(tag + msg), eval_every,
                               early_stop, checkpoint_dir, checkpoint_every,
                               log_dir, val_snapshot)
        held = None if early_stop is None else _HeldBest(early_stop, self)
        return super().fit(epochs, lambda msg: None, eval_every, held,
                           checkpoint_dir, checkpoint_every, None,
                           val_snapshot)

    # --------------------------------------------------------- checkpoints
    def _full_state(self):
        """The serial Engine's full state (the memory gathered whole) and
        ``dp_generators``, the dropout generator of every dp index."""
        st = super()._full_state()
        if self.use_memory:
            st["mem_state"] = dict(zip(self.mem_state._fields,
                                       self.full_memory_state()))
        # the states cross on the engine's device (NCCL takes no host
        # tensor)
        state = self.generator.get_state()[None].to(self.device)
        st["dp_generators"] = self.mesh.all_gather(state, "dp").cpu()
        return st

    def save_checkpoint(self, path: str) -> int:
        """Gather the full state on every rank; rank 0 writes it.  Returns
        the file's bytes (0 on other ranks)."""
        st = self._full_state()
        if self.mesh.rank:
            return 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_state(path, st)
        return os.path.getsize(path)

    def load_checkpoint(self, path: str):
        """``Engine.load_checkpoint`` on every rank, then this rank's
        memory shard and its dp index's generator."""
        st = super().load_checkpoint(path)
        if self.use_memory:
            self.mem_state = shard_state(self.mem_state, self.shard)
        # a row of the stacked states: set_state takes a tensor of its own
        self.generator.set_state(
            st["dp_generators"][self.mesh.d].cpu().clone())
        return st
