#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and runs on the GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Drives the port (tgb_tgn_dgl_tpu_torch; nothing of JAX) on one CUDA
device, phase by phase, one JSON line per phase:

  device     the card (nvidia-smi name and power limit), TF32 off, the
             kernels built from csrc/ with nvcc and the host libraries
             (csrc/packer.cpp, csrc/owned_state.cpp, csrc/hostops.cpp) with
             g++ at once, the build times and the g++ version
  kernels    each attention kernel at the main path's shapes and at shapes
             that reach its other routes (H % 4 != 0, a long row, a
             misaligned el'), against its plain torch version on the same
             inputs (out, the residual a, both gradients through autograd
             and from the backward kernel alone on the same a, and the
             inference forward under no_grad), with times and the
             memory/compute bound (the peaks of utils/flops.py); ms is
             device time alone (a device spin queued behind each L2 flush
             lets the host enqueue the call first), wall_ms the same
             events without the spin, which take in the wrapper's host
             time where it outlasts the flush; the inference forward is
             timed at the slot-unique embed chunk and at the column-chunk
             chunk, the dropout pair at the train batch and at the multi-host
             composed step's 2 x and 4 x 6,144 root slots, and every
             kernel at the sharded engine's dp = 2 shares (3,072 train
             root slots, half the slot-unique chunk); then the memory-row
             gather's backward (csrc/gather.cu through ops/gather.py) at
             the train cell's batch, 1,056,768 slots of D = 100 into
             7,168 rows with the packer's skew (70% of the slots on the
             trash row, 2% on one hub) in fp32 and bf16, with the same
             slots spread, and at the roots' 24,576 slots: each row within
             2e-6 (fp32) / 8e-3 (bf16) of its norm of a float64 sum, rows
             with no slot 0, a second call the same bits; ms is the kernel
             alone on sorted keys, op_ms the op with its sort, aten_ms
             aten's embedding_dense_backward (the backward it replaced) on
             the same keys, beside the byte bound
  reference  a tiny stream trained and evaluated (val, then test, by the
             slot-unique protocol) by the port on the GPU and on the CPU
             (plain versions) from the same weights
  memory_reference
             the same with the mailbox memory (frozen_memory: False):
             losses, val and test MRR and the final MemoryState must agree
  layer2_reference, vector_reference
             the same with two stacked attention layers (gnn.layer: 2, the
             column-chunk protocol, the attention kernels launched twice a
             step and a chunk), and with vector messages at one layer
  jodie_reference, dyrep_reference
             the same for JODIE (gnn.arch identity: no kernel launched)
             and DyRep (gnn.arch dyrep, the eager-mail memory with the
             partner's embedding in each message: attention_fwd and
             attention_bwd once a step); the eager state's computed mail
             is held within 1e-4 (its Δt-encoding columns within 1e-3),
             and DyRep's val pass also runs by column chunks from the
             state after training
  uniform_reference
             sampling.strategy 'uniform' (the numpy packer with the
             t-CSR's draws, csrc/hostops.cpp) on the tiny stream, frozen
             and with the memory: GPU against CPU as in memory_reference,
             every host wire of both runs equal, the val and test passes
             by column chunks (the gate closes), the dropout-0 pair once a
             step and the inference forward once a chunk
  bf16_reference
             train.compute_dtype bfloat16 on the tiny stream, frozen and
             with the memory: GPU against CPU, per-step losses within
             1e-3 (tests/test_torch_bf16.py's tolerance), then from the
             CPU run's weights and memory the slot-unique val pass on
             both (bf16 embedding tables), MRR within 1e-3
  device_cache_reference
             device-cache mode (train.device_cache) on the tiny stream,
             frozen and with the memory: GPU against CPU as in
             memory_reference (the device state exactly) and against the
             host-pack GPU engine; then a GPU run resumed from its epoch-1
             checkpoint must equal the uninterrupted run exactly (loss,
             val MRR, device state, memory), and a val pass between
             snapshot_stream and restore_stream must leave the device
             clocks bit-equal
  train_lean_reference
             the train-lean wire (train.wire_train_lean) on the tiny
             stream, frozen and with the memory: GPU against CPU, and
             against the full-Δt wire on the GPU
  nondeterminism
             one train step of the tiny memory stream (the serial Engine at
             100 events, MultiHostEngine's composed step at 2 x 100), run
             twice in the default mode and twice under deterministic
             algorithms: which gradients, parameters and MemoryState fields
             differ, and, from a trace of every aten op with its inputs'
             and outputs' checksums, which op's outputs differ on equal
             inputs
  sharded_reference
             ShardedEngine (parallel/engine.py) at world size 1 on the tiny
             stream at dropout 0, frozen, memory and JODIE: over NCCL on
             the GPU bit-equal to the serial GPU Engine (both under
             deterministic algorithms), and over gloo on the CPU within
             1e-6 (a step's loss, mem); the mesh's NCCL calls in the group
             of one
  sharded_two_rank
             two processes on the one card over gloo (python3 chip_smoke.py
             --sharded-worker <spec> <rank>; NCCL refuses two ranks on one
             device): ShardedEngine at dp = 2 x state = 1 and dp = 1 x
             state = 2 on the tiny memory stream against the serial GPU
             Engine (1 x 2 bit-equal, 2 x 1 within 2e-4 and its first
             step's gradients within 1e-4), the
             process-global wire's loss against the hosts' mean, and the
             owned exchange across processes against the serial pack
  wire       the native packer and the numpy packer in lockstep on the
             tgbl-wiki-shaped stream (TGN.yml widths): 4 train batches as
             dedup wires, one as a compact wire, then the first 2 and the
             last negative chunk of the first val batch as eval-lean
             dedup wires; each wire copied to the card and expanded there
             must equal to_device of the numpy pack, field by field and
             exactly.  Both packers' host ms per train batch and per eval
             chunk (the native one at most 1/8 of the numpy one), and the
             wire's bytes against the full grids'
  layer2_wire
             the same at layers=2 (configs/TGN-2layer.yml) with the wire
             the Engine ships there: 4 train batches and the first 2
             negative chunks of the first val batch as compact wires with
             their rslot fields, each expanded on the card equal to
             to_device of the numpy pack, nbr_rslot included
  lean_wire  device-cache mode's wire at TGN-memory.yml's packer settings
             on the tgbl-wiki-shaped stream: over the whole train split
             and every negative chunk of the first 2 val batches the lean
             packer, the host packer and the dedup packer in lockstep;
             expand_lean on the card must equal to_device of the host
             pack exactly, and after each batch the device state
             (advance_stream) the host packer's cache and clocks; the
             lean wire's bytes and host ms beside the dedup wire's
  train_lean_wire
             the train-lean wire on the same stream: every train batch's
             expansion on the card equal to the full-Δt wire's; both
             wires' bytes
  train      Engine on the tgbl-wiki-shaped synthetic stream with
             configs/TGN.yml at full width: the full train split (56 Adam
             steps) at the default dropout 0.2, the first step's time
             apart (from a CUDA event, so the epoch runs as the Engine
             runs it), then 2 steps of a second engine at dropout 0; the
             step's roofline reading at the epoch's edges/s: the FLOPs
             and HBM bytes of utils/flops.py at the shapes the packer
             padded to (engine_step_shapes: R, Kp, Ub from its sticky
             buckets), flops_per_event, tflops, mfu, hbm_gbps, hbm_util,
             the peaks read against (peak_flops for the compute dtype,
             float32 outside the tensor cores, TF32 off; peak_bps) and
             the nvidia-smi name and power limit
  eval       the streaming val pass with all 999 negatives per event, by
             the default gate, which must open (slot-unique): its
             protocol, batches, embed and score chunks, host times and
             peak device memory
  eval_unique_vs_chunked
             the column-chunk val pass from the stream state the eval
             phase started from: MRR within 1e-3 of the slot-unique
             pass's, the packer state after it equal, and its time
             beside it
  memory_train
             Engine with configs/TGN-memory.yml (GRU mailbox memory) at
             full width on the same stream: the full train split at
             dropout 0.2, with the roofline reading as in train
  memory_eval, memory_eval_unique_vs_chunked
             its val pass and the comparison, which also holds the
             MemoryStates after both passes equal (mem within 1e-4)
  uniform_train
             configs/TGN.yml with sampling.strategy 'uniform' at full
             width: the whole train split (each batch packed on the main
             thread by the numpy packer: fetch_s is the pack), then the
             val pass by column chunks over its first batch with all 999
             negatives, beside the 'recent' arm of the train and
             eval_unique_vs_chunked phases
  bf16_train configs/TGN.yml and configs/TGN-memory.yml at full width, each
             with compute_dtype float32 and bfloat16: the whole train
             split and the slot-unique val pass; edges/s, disp_s, peak
             memory, loss sum and MRR of each arm (fails on a non-finite
             loss or MRR only), and each dtype's roofline reading at the
             mean edges/s of its two epochs, against its own peak
  remat_train
             configs/TGN-memory.yml at full width with train.remat off and
             on under deterministic algorithms: parameters and MemoryState
             bit-equal after the train split; peak memory and edges/s
  device_cache_train, device_cache_eval, device_cache_memory_train,
  device_cache_memory_eval
             configs/TGN.yml and configs/TGN-memory.yml with
             device_cache: true at full width: the full train split, then
             the val pass (the gate must close with "device_cache mode":
             column chunks, each packed on the main thread), beside the
             host-pack arms above: edges/s, the val pass's seconds, host
             times, peak memory, wire bytes, the val MRR's difference
  train_lean_train, train_lean_memory_train
             the same two configurations with wire_train_lean: true, the
             full train split beside the host-pack arms
  layer2_train, layer2_eval
             configs/TGN-2layer.yml (two attention layers, GRU memory) at
             full width: the full train split at dropout 0.2, packed on the
             main thread, then the val pass, whose gate must close with
             "gnn.layer>1" (the column-chunk protocol)
  vector_train, vector_eval
             configs/TGN-memory.yml with message_mode: vector at full
             width: 8 train steps, then the val pass (slot-unique) and its
             peak device memory
  jodie_train, jodie_eval, dyrep_train, dyrep_eval
             configs/JODIE.yml and configs/DyRep.yml at full width (D=100,
             8 heads, K=10, batch 2000, msg 172; DyRep's mail 472 wide):
             the full train split at their dropout, then the val pass,
             whose gate must open (slot-unique)
  dyrep_eval_unique_vs_chunked
             DyRep's val pass again by column chunks from the same packer
             snapshot and eager state: MRR within 1e-3, the packer states
             equal, mem and mail within 1e-4, the rest of the state equal
  decoders   the decoder heads (link and node predictor, ConvTransE at
             D=200, 50 channels, kernel 3, 10,000 entities, 1,000
             queries) on the GPU against the CPU from the same
             parameters, in eval and train mode (dropout 0), and
             ConvTransE's running statistics after two train calls
  eval_low_dedup
             configs/TGN.yml on a stream of tgbl-review's 352,637 nodes
             and 100 negatives a row, cut to 70,000 events, where the JAX
             Engine's "auto" dedup estimate (under 1.5x) would take
             column chunks: one train epoch, then the val pass by the
             port's gate (slot-unique) and by column chunks from the same
             state, MRR and packer state held together, both timed
  device_cache_large_n
             configs/TGN.yml on the eval_low_dedup stream (352,637
             nodes, 70,000 events): one train epoch on the host packer and
             one in device-cache mode; seconds, host times, wire bytes and
             the device state's bytes
  pad_mask   a tiny stream with ragged negatives (1..24 a row), pad_mask
             and hits@10: GPU against CPU on val and test by both
             protocols, and each GPU val pass waits for the device once
  fit_reference
             Engine.fit on the tiny stream with the memory at dropout 0
             (attention_fwd/attention_bwd): 2 epochs with the val
             snapshot, a checkpoint an epoch and early stopping, GPU
             against CPU from the same weights (per-step losses, epoch
             losses, val MRRs); then a GPU engine resumed from the epoch-1
             checkpoint fits epoch 2: loss and val MRR equal to the
             uninterrupted run's
  fit        the port's CLI (tgb_tgn_dgl_tpu_torch/run_tgn.py, main) at
             full width: configs/TGN-memory.yml on the tgbl-wiki-shaped
             stream, --epochs 2 --checkpoint-every 1 --patience 5
             --val-snapshot --run-test --profile; then --resume from its
             epoch-1 checkpoint into a second and a third log directory
             (epoch 2: loss and val MRR equal to the first run's, and the
             two resumed runs equal), and
             --resume from its epoch-2 checkpoint --epochs 2 --run-test
             (no epoch trained; test MRR within 1e-6 of the first run's).
             Each epoch's train seconds and edges/s, the val passes'
             seconds, the checkpoint's bytes and save and load seconds,
             the trace's bytes and whether it names the attention
             kernels, the metrics.jsonl events; each run's launches
             (the dropout pair 56 an epoch trained, attention_fwd_infer
             once an embed chunk of its val and test passes)
  multihost_reference
             MultiHostEngine (parallel/mh_engine.py) at 2 hosts on the tiny
             stream at dropout 0 (2 super-batches of 2 x 100 events, 2 tail
             batches): frozen TGN, the memory, JODIE and DyRep, GPU against
             CPU from the same weights (each step's loss, the parameters,
             the memory state, the packer state exactly), and for the
             memory and DyRep the owned exchange bit-equal to the
             replicated one on the GPU; the dropout-0 pair once a composed
             step (DyRep: once a range) and once a tail step
  multihost_train
             configs/TGN-memory.yml at full width at 2 hosts: one epoch
             (27 super-batches, 2 tail batches; the buckets warmed first,
             timed apart) and the slot-unique val pass with the replicated
             and with the owned exchange from the same weights, beside the
             serial memory_train epoch: edges/s, every last_epoch_trace
             field, peak memory; the packer state after the epoch equal to
             the serial Engine's
  multihost_frozen_train, multihost_jodie_train, multihost_dyrep_train
             configs/TGN.yml at 4 hosts (13 super-batches, 4 tail
             batches), JODIE.yml and DyRep.yml at 2 hosts: one epoch each
             beside the serial epoch of this call
  multihost_host_only
             the host work alone (train_epoch(host_only=True): range packs,
             exchange, mail re-plan, composition) of TGN-memory.yml at 2
             and 4 hosts, replicated against owned; host_s, the work one
             host of such a deployment does; no kernel may launch
  sharded_train
             the CLI with --engine sharded --dp 1 --state-ax 1 at full
             width (TGN-memory.yml, one epoch after the warm-up and the
             slot-unique val pass) beside the serial CLI arm: loss sum and
             val MRR equal, the same launches, edges/s, host times, val
             seconds, peak memory
  sharded_two_rank_train
             TGN-memory.yml at full width with dropout 0 at dp = 2 on two
             processes of the card over gloo, beside a serial arm at
             dropout 0: epoch and val seconds, the collectives' calls,
             bytes and host seconds; the first step's gradient vector
             within 1e-4 (norm-relative) of the serial arm's, loss and val MRR
             within 5e-3 of it; each rank's launches equal to the serial
             arm's at half its root slots; control arms with a planted
             fault (gradients averaged instead of summed over dp, the
             table's backward without its reduce-scatter) must fail the
             gradient check
  counters   launches of each kernel on the frozen path (train + eval;
             all five must be > 0), on the memory path (memory_train +
             memory_eval; the dropout pair and the inference forward must
             be > 0), on the layer-2 path (layer2_train + layer2_eval; the
             same three, exactly twice a step or a chunk), on the vector
             path (plain torch: none), on the JODIE path (none) and on the
             DyRep path (the dropout pair exactly once a step, the
             inference forward once an embed chunk), on the fit path (the
             fit phase's first CLI run: the dropout pair 56 times an
             epoch, the inference forward once an embed chunk of its two
             val passes and its test pass), on the device-cache paths
             (TGN.yml and TGN-memory.yml: the dropout pair 56 times an
             epoch, the inference forward once a column chunk) and the
             train-lean paths (the dropout pair 56 times an epoch), on
             the multi-host paths (the dropout pair once a composed step,
             DyRep's once a range, and once a tail step: 29 for
             TGN-memory.yml at 2 hosts with each exchange, 17 for TGN.yml
             at 4, 56 for DyRep.yml at 2, none for JODIE; the inference
             forward once an embed chunk of the TGN-memory.yml arms' val
             passes), on the sharded paths (world size 1: the serial CLI
             arm's launches; dp = 2, rank 0: the dropout-0 serial arm's),
             on the knobs' paths ('uniform': the dropout pair 56 times an
             epoch, the inference forward once a column chunk; bf16, frozen
             and memory: the float32 arm's counts; remat:
             attention_fwd_drop twice a step, attention_bwd_drop once),
             each path's counts set to 0 just before it; the kernel table
             sums them.  gather_bwd beside them on the paths that count
             it: twice a train step where a memory model with attention
             trains (memory, layer-2, vector, DyRep, fit, device-cache and
             train-lean memory, multi-host memory and DyRep, bf16 and
             remat memory), never in an eval pass, none on the frozen,
             JODIE and 'uniform' paths
  profile    torch.profiler over 4 train steps and one val batch (by the
             slot-unique and by the column-chunk protocol) of a fresh
             engine, frozen, memory, JODIE and DyRep, and at gnn.layer 2
             (one val batch by column chunks); in device-cache mode (4
             train steps, one val batch by column chunks) and with the
             train-lean wire (4 train steps): wall time, host packing,
             kernel launches,
             device busy time
             and the kernels that take it; then each run again under
             torch.cuda's sync debug mode, which must see one
             synchronization only (the pass's one fetch of its metrics)

Every phase that runs an Engine reports its host time getting device
wires (``pack_s``: the wait for the packer thread, the submit of the next
batch, the eval-lean post-pass, the copy's enqueue), its parts in the
packer's fetch (``fetch_s``: the wait for the thread and the read of its
buffers) and in ``wire_to_device`` (``copy_s``: pinning and enqueueing
the copies), and its time dispatching the expansion and the model
(``disp_s``).  Then the kernel table as one JSON line, the nvidia-smi
line, and last
``{"ok": true, "device": {...}}``.  Any failure prints the phase's error
and exits 1; without a CUDA device, or outside the repository, it exits 2
and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

SLOPE = 0.2
KEEP = 0.8                    # att_dropout 0.2
FWD_TOL = 1e-5                # |kernel - plain| <= tol + tol·|plain|
GRAD_TOL = 1e-4
L2_FLUSH_BYTES = 128 << 20    # > the 50 MB L2
TIMED_RUNS = 30
SPIN_CYCLES = 2_000_000       # about 1 ms of device time

# per (r, k, h) element: fwd = add, leaky (cmp, mul), running max/sum
# (cmp, exp, add), exp, div, mul, add; bwd = two passes of mul/add plus
# softmax and leaky backward.  Dropout adds one multiply per use.
OPS_PER_ELEM = {"attention_fwd": 10, "attention_fwd_infer": 10,
                "attention_fwd_drop": 11, "attention_bwd": 12,
                "attention_bwd_drop": 14}
REPLACES = {
    "attention_fwd": "tgb_tgn_dgl_tpu/ops/pallas_attention.py:52",
    "attention_fwd_infer": "tgb_tgn_dgl_tpu/ops/pallas_attention.py:52",
    "attention_bwd": "tgb_tgn_dgl_tpu/ops/pallas_attention.py:68",
    "attention_fwd_drop": "tgb_tgn_dgl_tpu/ops/pallas_attention.py:88",
    "attention_bwd_drop": "tgb_tgn_dgl_tpu/ops/pallas_attention.py:112",
}
SOURCE = "tgb_tgn_dgl_tpu_torch/csrc/attention.cu"
# (label, R, Kp, H, fully masked rows as a fraction of R).  odd_h takes
# the forward's float route (H % 4 != 0), long_kp its chunked route (a row
# of more than 48 floats a lane over 32 lanes), misaligned both (el'
# starts 4 bytes past a 16-byte boundary), odd_h_long the float route
# with lanes that a head vector does not fill (the tree reduction)
SHAPES = [("train", 6144, 43, 8, 0.02), ("eval", 40960, 43, 8, 0.02),
          ("eval_unique", 46812, 43, 8, 0.02),
          ("composed", 12288, 43, 8, 0.02),
          ("composed_n4", 24576, 43, 8, 0.02),
          ("train_dp2", 3072, 43, 8, 0.02),
          ("eval_unique_dp2", 23406, 43, 8, 0.02),
          ("masked", 512, 43, 8, 0.5), ("odd_kp", 1000, 17, 8, 0.0),
          ("odd_h", 999, 17, 3, 0.1), ("long_kp", 512, 200, 8, 0.1),
          ("misaligned", 1000, 200, 8, 0.1),
          ("odd_h_long", 999, 200, 3, 0.1)]
# the shapes each kernel is timed at, the first one its record in the
# table: the slot-unique embed chunk for the inference forward that the
# val pass runs (the largest chunk of a 327,680-slot table: 7 chunks of
# 46,812; also the column-chunk protocol's 40,960-slot chunk, beside it),
# the column chunk for the training forward, the train batch for the
# others; the dropout pair also at the multi-host composed step's root
# slots, N x 6,144 at N = 2 (composed) and 4 (composed_n4); and the dp = 2
# shares of the sharded engine: half the train batch's root slots
# (train_dp2: every kernel of a train step, the dropout pair at the
# config's dropout and the dropout-0 pair) and half the slot-unique chunk
# (eval_unique_dp2)
TIMED_SHAPES = {"attention_fwd": ("eval", "train_dp2"),
                "attention_fwd_infer": ("eval_unique", "eval",
                                        "eval_unique_dp2"),
                "attention_fwd_drop": ("train", "composed", "composed_n4",
                                       "train_dp2"),
                "attention_bwd": ("train", "train_dp2"),
                "attention_bwd_drop": ("train", "composed", "composed_n4",
                                       "train_dp2")}
# what the memory path's train (dropout 0.2) and eval launch
MEMORY_PATH_KERNELS = ("attention_fwd_drop", "attention_bwd_drop",
                       "attention_fwd_infer")
# train steps of the vector-message path (its (R, Kp, H, D) tensors make a
# step several times as slow as a scalar one)
VECTOR_STEPS = 8
# DyRep's stored mail ends with cos(w·Δt + b): at |Δt| up to ~10^3 one ulp
# of the fp32 argument is 6e-5, so those columns get their own tolerance
MAIL_TE_TOL = 1e-3
# the memory-row gather's backward at the train cell's batch (R 24,576
# root slots x Kp 43 columns, D 100, Ub up to 7,168 rows): (label, slots,
# key layout, dtype), the first the kernel table's record; 'skew' is the
# packer's layout (70% on the trash row, 2% on one hub, the rest
# uniform), 'spread' the same slots uniform over the rows
GATHER_SOURCE = "tgb_tgn_dgl_tpu_torch/csrc/gather.cu"
GATHER_U, GATHER_D = 7_168, 100
GATHER_SHAPES = [("train", 24_576 * 43, "skew", "float32"),
                 ("train_bf16", 24_576 * 43, "skew", "bfloat16"),
                 ("train_spread", 24_576 * 43, "spread", "float32"),
                 ("roots", 24_576, "skew", "float32")]
GATHER_TOL = {"float32": 2e-6, "bfloat16": 8e-3}   # of each row's norm


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_counts(attention) -> None:
    """The attention kernels' launch counters and the gather backward's
    from 0."""
    from tgb_tgn_dgl_tpu_torch.ops import gather
    attention.reset_launch_counts()
    gather.reset_launch_counts()


def counts_now(attention) -> dict:
    """Launches since ``reset_counts``: the attention kernels' and
    ``gather_bwd``."""
    from tgb_tgn_dgl_tpu_torch.ops import gather
    return {**attention.launch_counts, **gather.launch_counts}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ kernels
def kernel_inputs(torch, R, Kp, H, masked_frac, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    el = torch.randn((R, Kp, H), generator=g, device=dev)
    er = torch.randn((R, H), generator=g, device=dev)
    mask = torch.rand((R, Kp), generator=g, device=dev) < 0.7
    mask[:, 10] = True                     # the self-loop column
    n_masked = int(R * masked_frac)
    if n_masked:                           # padded root slots at the end
        mask[R - n_masked:] = False
    dm = (torch.rand((R, Kp, H), generator=g, device=dev) < KEEP).float()
    dm /= KEEP
    grad = torch.randn((R, H), generator=g, device=dev)
    return el, er, mask, dm, grad


def _leaf(torch, t, misaligned):
    """A copy of ``t`` that takes a gradient; with ``misaligned`` its data
    starts 4 bytes into a larger buffer."""
    if not misaligned:
        return t.clone().requires_grad_(True)
    view = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
    return view.copy_(t).requires_grad_(True)


def time_ms(torch, fn, flush, spin=True) -> float:
    """Median device time of ``fn`` over TIMED_RUNS launches, each after
    an L2 flush (the main path reads el' once per call) and, with
    ``spin``, a device spin of SPIN_CYCLES queued behind the flush: the
    host enqueues ``fn`` while the device spins, so the events time the
    device's work alone.  Without it (``wall_ms``) the events also take in
    the host's time in ``fn`` (a wrapper's allocations, its ctypes call)
    wherever that outlasts the flush."""
    fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _err(got, want):
    d = (got - want).abs()
    return float(d.max()), float((d / want.abs().clamp(min=1e-6)).max())


def kernel_bound(name, R, Kp, H):
    from tgb_tgn_dgl_tpu_torch.utils.flops import (H100_PEAK_FP32_FLOPS,
                                                   H100_PEAK_HBM_BPS)
    rkh, rh = R * Kp * H, R * H
    drop = name.endswith("_drop")
    if name == "attention_fwd_infer":
        # el', er, mask in; out out
        nbytes = 4 * rkh + 4 * rh + R * Kp + 4 * rh
    elif name.startswith("attention_fwd"):
        # el', er, mask, [dm] in; out, a out
        nbytes = 4 * rkh + 4 * rh + R * Kp + 4 * rh + 4 * rkh
    else:
        # el', er, mask, [dm], a, grad in; d_el', d_er out
        nbytes = (4 * rkh + 4 * rh + R * Kp + 4 * rkh + 4 * rh
                  + 4 * rkh + 4 * rh)
    nbytes += 4 * rkh if drop else 0
    ops = OPS_PER_ELEM[name] * rkh
    t_bytes = nbytes / H100_PEAK_HBM_BPS * 1e3
    t_ops = ops / H100_PEAK_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def gather_keys(torch, S, layout, seed):
    """(S,) int32 row keys in [0, GATHER_U) laid out as GATHER_SHAPES
    says, in shuffled slot order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    U = GATHER_U
    if layout == "spread":
        keys = torch.randint(0, U, (S,), generator=g, device="cuda")
    else:
        n_trash, n_hub = int(0.7 * S), int(0.02 * S)
        keys = torch.cat([
            torch.full((n_trash,), U - 1, device="cuda"),
            torch.full((n_hub,), 17, device="cuda"),
            torch.randint(0, U - 1, (S - n_trash - n_hub,), generator=g,
                          device="cuda")])
        keys = keys[torch.randperm(S, generator=g, device="cuda")]
    return keys.to(torch.int32)


def _worst_row(torch, got, want, used):
    err = torch.linalg.vector_norm(got.double() - want, dim=1)
    norm = torch.linalg.vector_norm(want, dim=1)
    return float((err[used] / norm[used]).max())


def gather_kernel(torch, gather, flush) -> dict:
    """The memory-row gather's backward at GATHER_SHAPES: checked against
    a float64 ``index_add_`` and timed beside aten's
    ``embedding_dense_backward``.  Bound: keys, gradient and table each
    moved once.  Returns the first shape's record."""
    from tgb_tgn_dgl_tpu_torch.utils.flops import H100_PEAK_HBM_BPS
    U, D = GATHER_U, GATHER_D
    records = []
    for si, (label, S, layout, dtype) in enumerate(GATHER_SHAPES):
        keys = gather_keys(torch, S, layout, seed=100 + si)
        long_keys = keys.long()
        gen = torch.Generator(device="cuda").manual_seed(200 + si)
        g = torch.randn((S, D), generator=gen, device="cuda").to(
            getattr(torch, dtype))
        before = gather.launch_counts["gather_bwd"]
        got = gather.gather_bwd(keys, g, U)
        if gather.launch_counts["gather_bwd"] != before + 1:
            raise AssertionError(f"gather_bwd {label}: not counted")
        want = torch.zeros((U, D), dtype=torch.float64, device="cuda")
        want.index_add_(0, long_keys, g.double())
        rows = torch.bincount(long_keys, minlength=U)
        used = rows > 0
        aten = torch.ops.aten.embedding_dense_backward(g, long_keys, U, -1,
                                                       False)
        key, slot = torch.sort(keys, stable=True)
        out = torch.zeros_like(got)
        worst = _worst_row(torch, got, want, used)
        ok = (bool(torch.isfinite(got).all()) and worst <= GATHER_TOL[dtype]
              and bool((got[~used] == 0).all()))
        ms = time_ms(torch, lambda: gather.gather_bwd_sorted(key, slot, g,
                                                             out), flush)
        # the kernel into a table it wrote before: the same bits
        ok = ok and torch.equal(out, got)
        op = lambda: gather.gather_bwd(keys, g, U)      # noqa: E731
        nbytes = 4 * S + g.element_size() * (S * D + U * D)
        bound_ms = nbytes / H100_PEAK_HBM_BPS * 1e3
        rec = dict(phase="kernels", kernel="gather_bwd", label=label,
                   timed_at=[S, D, U], keys=layout, dtype=dtype,
                   largest_row=int(rows.max()), ms=ms,
                   op_ms=time_ms(torch, op, flush),
                   wall_ms=time_ms(torch, op, flush, spin=False),
                   aten_ms=time_ms(
                       torch, lambda: torch.ops.aten.embedding_dense_backward(
                           g, long_keys, U, -1, False), flush),
                   plain_ms=time_ms(
                       torch, lambda: gather.gather_rows_bwd_reference(
                           keys, g, U), flush),
                   bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
                   pct_of_bound=100.0 * bound_ms / ms,
                   worst_row_err=worst,
                   aten_worst_row_err=_worst_row(torch, aten, want, used),
                   tol=GATHER_TOL[dtype], ok=ok)
        rec["op_pct_of_bound"] = 100.0 * bound_ms / rec["op_ms"]
        emit(rec)
        if not ok:
            raise AssertionError(f"gather_bwd {label}: worst row {worst} "
                                 f"over {GATHER_TOL[dtype]} of its norm, a "
                                 f"row with no slot not 0, or a second "
                                 f"call other bits")
        records.append(rec)
        del g, aten, want, out
    return dict(records[0], max_worst_row_err=max(
        r["worst_row_err"] for r in records))


def phase_kernels(torch, attention, gather):
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    infer = "attention_fwd_infer"
    results = {}
    rows = []
    for si, (label, R, Kp, H, frac) in enumerate(SHAPES):
        el, er, mask, dm, grad = kernel_inputs(torch, R, Kp, H, frac, seed=si)
        probs = attention.attention_probs_reference(el, er, mask, SLOPE)
        n_masked = int(R * frac)
        for drop in (False, True):
            dmask = dm if drop else None
            fwd = "attention_fwd_drop" if drop else "attention_fwd"
            bwd = "attention_bwd_drop" if drop else "attention_bwd"
            # kernel through autograd, as the model calls it
            el_k = _leaf(torch, el, label == "misaligned")
            er_k = er.clone().requires_grad_(True)
            out_k = attention.attention_core(el_k, er_k, mask, SLOPE, dmask)
            out_k.backward(grad)
            # the forward kernel's residual: the softmax before dropout
            a = attention.attention_fwd(el_k.detach(), er, mask, SLOPE,
                                        dmask)[1]
            # the backward kernel alone, on that residual
            d_el_k, d_er_k = attention.attention_bwd(el_k.detach(), er, mask,
                                                     a, grad, SLOPE, dmask)
            # plain versions on the same inputs
            el_p = el.clone().requires_grad_(True)
            er_p = er.clone().requires_grad_(True)
            out_p = attention.attention_core_reference(el_p, er_p, mask,
                                                       SLOPE, dmask)
            out_p.backward(grad)
            d_el_p, d_er_p = attention.attention_bwd_reference(
                el, er, mask, a, grad, SLOPE, dmask)
            checks = {fwd: [("out", out_k.detach(), out_p.detach(),
                             FWD_TOL), ("a", a, probs, FWD_TOL)],
                      bwd: [("d_el", el_k.grad, el_p.grad, GRAD_TOL),
                            ("d_er", er_k.grad, er_p.grad, GRAD_TOL),
                            ("d_el_direct", d_el_k, d_el_p, GRAD_TOL),
                            ("d_er_direct", d_er_k, d_er_p, GRAD_TOL)]}
            zeros = [out_k, el_k.grad, er_k.grad, a, d_el_k, d_er_k]
            if not drop:                   # the route that eval takes
                before = attention.launch_counts[infer]
                with torch.no_grad():
                    out_i = attention.attention_core(el_k, er_k, mask, SLOPE)
                if attention.launch_counts[infer] != before + 1:
                    raise AssertionError(f"{label}: no_grad did not take "
                                         f"{infer}")
                checks[infer] = [("out", out_i, out_p.detach(), FWD_TOL)]
                zeros.append(out_i)
            torch.cuda.synchronize()
            if n_masked:                   # padded rows: exact zeros
                for t in zeros:
                    if t[R - n_masked:].abs().max() != 0:
                        raise AssertionError(
                            f"{label}: fully masked rows are not zero")
            for name, items in checks.items():
                for what, got, want, tol in items:
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{name} {label}: non-finite")
                    ok = bool(((got - want).abs()
                               <= tol + tol * want.abs()).all())
                    abs_e, rel_e = _err(got, want)
                    rows.append(dict(kernel=name, shape=label,
                                     R=R, Kp=Kp, H=H, output=what,
                                     max_abs_err=abs_e, max_rel_err=rel_e,
                                     tol=tol, ok=ok))
                    if not ok:
                        raise AssertionError(
                            f"{name} {label} {what}: max abs err {abs_e} "
                            f"over tolerance {tol}")
                    rec = results.setdefault(name, {"max_abs_err": 0.0})
                    rec["max_abs_err"] = max(rec["max_abs_err"], abs_e)

            # times at the shapes the main path gives each kernel
            def plain_fwd(d=dmask):
                with torch.no_grad():
                    attention.attention_core_reference(el, er, mask, SLOPE, d)

            def plain_bwd(d=dmask, a=a):
                with torch.no_grad():
                    attention.attention_bwd_reference(el, er, mask, a, grad,
                                                      SLOPE, d)

            timed = {
                fwd: (lambda: attention.attention_fwd(el, er, mask, SLOPE,
                                                      dmask), plain_fwd),
                bwd: (lambda: attention.attention_bwd(el, er, mask, a, grad,
                                                      SLOPE, dmask),
                      plain_bwd)}
            if not drop:
                timed[infer] = (lambda: attention.attention_fwd_infer(
                    el, er, mask, SLOPE), plain_fwd)
            for name, (run, plain) in timed.items():
                if label not in TIMED_SHAPES[name]:
                    continue
                ms = time_ms(torch, run, flush)
                wall_ms = time_ms(torch, run, flush, spin=False)
                plain_ms = time_ms(torch, plain, flush)
                bound_ms, bound_by, nbytes = kernel_bound(name, R, Kp, H)
                results[name].setdefault("timed", {})[label] = dict(
                    shape=[R, Kp, H], ms=ms, wall_ms=wall_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    bytes=nbytes)
            del out_p, el_p, er_p, d_el_k, d_el_p
    for row in rows:
        emit(dict(phase="kernels", **row))
    for name in attention.KERNELS:
        for label in TIMED_SHAPES[name]:
            r = results[name]["timed"][label]
            emit(dict(phase="kernels", kernel=name, label=label,
                      timed_at=r["shape"],
                      ms=r["ms"], wall_ms=r["wall_ms"],
                      plain_ms=r["plain_ms"],
                      bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                      bytes=r["bytes"],
                      pct_of_bound=100.0 * r["bound_ms"] / r["ms"]))
        # the table's record: the first shape
        results[name].update(results[name]["timed"][TIMED_SHAPES[name][0]])
    results["gather_bwd"] = gather_kernel(torch, gather, flush)
    return results


# ------------------------------------------------------------ engine runs
REFERENCE_RAW = dict(sampling=[dict(neighbor=[5])],
                     gnn=[dict(att_head=4, dim_out=32, dim_time=32)],
                     train=[dict(batch_size=100, lr=1e-3, dropout=0.0,
                                 att_dropout=0.0, eval_neg_chunk=3)])
LOSS_TOL = 1e-4
MRR_TOL = 1e-3
MEM_TOL = 1e-4


def _tiny(pkg, num_neg=8):
    return pkg.synthetic("tiny", num_edges=855, num_nodes=120, msg_dim=8,
                         num_neg=num_neg, seed=1)


def _recorder(eng):
    """Wrap ``eng._train_step`` to append each step's loss to a list."""
    losses, step = [], eng._train_step

    def rec(pack, acc):
        loss, acc = step(pack, acc)
        losses.append(float(loss))
        return loss, acc

    eng._train_step = rec
    return losses


def _recording_engine(pkg, raw, dev):
    """An engine of ``raw`` on the tiny stream on ``dev``, and the list its
    train steps append their losses to."""
    eng = pkg.Engine(_tiny(pkg), pkg.parse_config_dict(raw), device=dev)
    return eng, _recorder(eng)


def _gpu_and_cpu(pkg, raw, protocol="slot_unique", chunked=False,
                 on_engine=None):
    """Train one epoch and run the val pass, then the test pass, of the
    tiny stream on the GPU and on the CPU from the same seed (so the same
    weights), the val pass by ``protocol``; returns {device: (per-step
    losses, val MRR, engine, test MRR)}.  With ``chunked`` each device
    first runs the val pass by column chunks from the state after
    training and restores that state; its MRR ends the tuple.
    ``on_engine(device, engine)`` sees each engine before it trains."""
    out = {}
    for dev in ("cuda", "cpu"):
        eng, losses = _recording_engine(pkg, raw, dev)
        if on_engine is not None:
            on_engine(dev, eng)
        eng.train_epoch()
        extra = ()
        if chunked:
            snap = _stream_state(eng)
            extra = (eng._evaluate_chunked("val"),)
            eng.packer.restore(snap[0])
            eng.mem_state = snap[1]
        val = eng.evaluate("val")
        if eng.last_eval_trace["protocol"] != protocol:
            raise AssertionError(f"the reference val pass did not take the "
                                 f"{protocol} protocol")
        out[dev] = (losses, val, eng, eng.evaluate("test"), *extra)
    return out


def _host_times(eng):
    """The host time of an engine's last train epoch and eval pass."""
    tr, ev = eng.last_epoch_trace, eng.last_eval_trace
    return {f"{k}_{n}": t[n] for k, t in (("train", tr), ("eval", ev))
            for n in ("pack_s", "fetch_s", "copy_s", "disp_s")}


def _compare_runs(phase, out):
    (lg, mg, eng, tg), (lc, mc, _, tc) = out["cuda"][:4], out["cpu"][:4]
    loss_err = max(abs(a - b) for a, b in zip(lg, lc))
    res = dict(phase=phase, steps=len(lg), losses_gpu=lg,
               losses_cpu=lc, max_loss_diff=loss_err, mrr_gpu=mg,
               mrr_cpu=mc, test_mrr_gpu=tg, test_mrr_cpu=tc,
               loss_tol=LOSS_TOL, mrr_tol=MRR_TOL,
               protocol=eng.last_eval_trace["protocol"], **_host_times(eng))
    ok = (len(lg) == 6 and loss_err <= LOSS_TOL and abs(mg - mc) <= MRR_TOL
          and abs(tg - tc) <= MRR_TOL)
    return res, ok


def phase_reference(torch, pkg):
    """Tiny stream, same weights, dropout 0: the GPU engine (kernels) and
    the CPU engine (plain versions) must agree step by step, and on the
    val and the test MRR (slot-unique eval)."""
    res, ok = _compare_runs("reference", _gpu_and_cpu(pkg, REFERENCE_RAW))
    emit(res)
    if not ok:
        raise AssertionError("GPU and CPU engines disagree")


MEMORY_RAW = dict(REFERENCE_RAW, memory=[dict(dim_out=32, dim_time=32)],
                  train=[dict(REFERENCE_RAW["train"][0],
                              frozen_memory=False)])


def _with_gnn(raw, **gnn):
    return dict(raw, gnn=[dict(raw["gnn"][0], **gnn)])


def _state_diff(torch, got, want, te_tol=MEM_TOL):
    """Two memory states (``MemoryState`` or DyRep's ``EagerMemoryState``)
    side by side: the largest difference of ``mem`` and, for the eager
    state, of its computed ``mail`` (the Δt-encoding columns, the last D,
    apart), the fields that are not equal among the others, and whether
    all is within MEM_TOL (``te_tol`` for the Δt-encoding columns)."""
    def err(a, b):
        return float((a.cpu() - b.cpu()).abs().max()) if a.numel() else 0.0

    res = dict(max_mem_diff=err(got.mem, want.mem), mem_tol=MEM_TOL)
    ok = res["max_mem_diff"] <= MEM_TOL
    if "mail" in want._fields:
        D = want.mem.shape[1]
        res.update(max_mail_diff=err(got.mail[..., :-D], want.mail[..., :-D]),
                   max_mail_te_diff=err(got.mail[..., -D:],
                                        want.mail[..., -D:]),
                   mail_te_tol=te_tol)
        ok = (ok and res["max_mail_diff"] <= MEM_TOL
              and res["max_mail_te_diff"] <= te_tol)
    res["unequal_state_fields"] = [
        f for f in want._fields if f not in ("mem", "mail")
        and not torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu())]
    return res, ok and not res["unequal_state_fields"]


def phase_memory_reference(torch, pkg, phase="memory_reference",
                           raw=MEMORY_RAW, protocol="slot_unique",
                           chunked=False, on_engine=None, extra=None):
    """The reference phase with the mailbox memory: losses and MRRs as
    there, and the final memory state (after the val and test passes)
    equal: mem within MEM_TOL, DyRep's computed mail within MEM_TOL (its
    Δt-encoding columns within MAIL_TE_TOL), the other fields exactly.
    With ``chunked`` each device also runs the val pass by column chunks
    from the state after training, first, and its MRR must agree too.
    ``on_engine`` goes to ``_gpu_and_cpu``; ``extra()`` returns fields to
    report and whether its own check passed.  Returns the GPU run's
    launches of each kernel and its steps."""
    from tgb_tgn_dgl_tpu_torch.ops import attention
    attention.reset_launch_counts()
    out = _gpu_and_cpu(pkg, raw, protocol, chunked, on_engine)
    launches = dict(attention.launch_counts)   # the CPU run launches none
    res, ok = _compare_runs(phase, out)
    sg, sc = out["cuda"][2].mem_state, out["cpu"][2].mem_state
    diff, same = _state_diff(torch, sg, sc, MAIL_TE_TOL)
    res.update(diff, mem_nonzero_rows=int((sc.mem.abs().sum(1) > 0).sum()),
               valid_mail=int(sc.mail_valid.sum()), launches_gpu=launches)
    if chunked:
        cg, cc = out["cuda"][4], out["cpu"][4]
        res.update(chunked_mrr_gpu=cg, chunked_mrr_cpu=cc)
        ok = ok and abs(cg - cc) <= MRR_TOL and abs(cg - out["cuda"][1]) \
            <= MRR_TOL
    if extra is not None:
        fields, good = extra()
        res.update(fields)
        ok = ok and good
    emit(res)
    if not ok or not same or res["valid_mail"] == 0:
        raise AssertionError(f"{phase}: GPU and CPU memory engines disagree")
    return launches, res["steps"]


def phase_layer2_reference(torch, pkg):
    """gnn.layer: 2 with the memory on the tiny stream, GPU against CPU as
    in memory_reference; the val pass takes column chunks, and the GPU
    run launches the dropout-0 pair twice a step."""
    launches, steps = phase_memory_reference(
        torch, pkg, "layer2_reference", _with_gnn(MEMORY_RAW, layer=2),
        "column_chunk")
    twice = {k: launches[k] for k in ("attention_fwd", "attention_bwd")}
    if twice != {k: 2 * steps for k in twice}:
        raise AssertionError(f"layer2_reference: {twice} in {steps} steps")


def phase_vector_reference(torch, pkg):
    """message_mode: vector at one layer with the memory, GPU against CPU
    as in memory_reference (slot-unique eval).  Vector attention is plain
    torch: the GPU run launches no kernel."""
    launches, _ = phase_memory_reference(
        torch, pkg, "vector_reference",
        _with_gnn(MEMORY_RAW, message_mode="vector"))
    if any(launches.values()):
        raise AssertionError(f"vector_reference launched {launches}")


def _arch_raw(arch, **memory):
    """MEMORY_RAW for ``arch`` with the RNN cell (JODIE.yml, DyRep.yml)."""
    return _with_gnn(dict(MEMORY_RAW, memory=[dict(
        MEMORY_RAW["memory"][0], memory_update="rnn", **memory)]),
        arch=arch)


def phase_jodie_reference(torch, pkg):
    """JODIE (gnn.arch identity) on the tiny stream, GPU against CPU as in
    memory_reference (slot-unique eval).  Its embedding is the time
    projection of the memory, with no attention: no kernel launches."""
    launches, _ = phase_memory_reference(torch, pkg, "jodie_reference",
                                         _arch_raw("identity"))
    if any(launches.values()):
        raise AssertionError(f"jodie_reference launched {launches}")


def phase_dyrep_reference(torch, pkg):
    """DyRep (gnn.arch dyrep, each message holding the partner's
    embedding) on the tiny stream, GPU against CPU as in memory_reference,
    the eager state's mail included, and the val pass by column chunks
    from the state after training too.  The dropout-0 pair runs once a
    step, the inference forward in the eval passes."""
    launches, steps = phase_memory_reference(
        torch, pkg, "dyrep_reference",
        _arch_raw("dyrep", use_dst_emb_in_msg=True), chunked=True)
    pair = {k: launches[k] for k in ("attention_fwd", "attention_bwd")}
    if pair != {k: steps for k in pair} or not launches[
            "attention_fwd_infer"]:
        raise AssertionError(f"dyrep_reference: {launches} in {steps} steps")


# 'uniform' sampling (the numpy packer with the t-CSR of the stream)
UNIFORM_RAW = dict(REFERENCE_RAW, sampling=[dict(
    REFERENCE_RAW["sampling"][0], strategy="uniform")])


def _wire_recorder(eng):
    """Wrap ``eng._pack_wire`` (every batch and chunk is packed there on
    the main thread under 'uniform'): the host wires, in order."""
    wires, pack = [], eng._pack_wire

    def rec(args, kw):
        out = pack(args, kw)
        wires.append(out)
        return out

    eng._pack_wire = rec
    return wires


def _unequal_wires(a, b):
    """Indices of two lists of (host wire, intra width) that differ in
    type, width or any field (and -1 when the lengths differ)."""
    import numpy as np
    bad = [] if len(a) == len(b) else [-1]
    for i, ((wa, ia), (wb, ib)) in enumerate(zip(a, b)):
        same = ia == ib and type(wa) is type(wb) and all(
            (x is None) == (y is None)
            and (x is None or (np.asarray(x).dtype == np.asarray(y).dtype
                               and np.array_equal(x, y)))
            for x, y in zip(wa, wb))
        if not same:
            bad.append(i)
    return bad


def phase_uniform_reference(torch, pkg):
    """sampling.strategy 'uniform' on the tiny stream at dropout 0, frozen
    and with the memory: the GPU engine against the CPU engine.  Both pack
    on the host with the numpy packer and the same t-CSR draws, so every
    wire (train batches, then each column chunk of the val and test
    passes: the gate closes) must be equal; losses, MRRs and the memory
    state as in memory_reference.  The dropout-0 pair once a step, the
    inference forward once a column chunk."""
    from tgb_tgn_dgl_tpu_torch.ops import attention
    for label, raw in (("frozen", UNIFORM_RAW),
                       ("memory", dict(MEMORY_RAW,
                                       sampling=UNIFORM_RAW["sampling"]))):
        wires = {}

        def on_engine(dev, eng):
            wires[dev] = _wire_recorder(eng)

        def extra():
            bad = _unequal_wires(wires["cuda"], wires["cpu"])
            return (dict(arm=label, wires=len(wires["cuda"]),
                         unequal_wires=bad), not bad)

        if label == "memory":
            launches, steps = phase_memory_reference(
                torch, pkg, "uniform_reference", raw, "column_chunk",
                on_engine=on_engine, extra=extra)
        else:
            attention.reset_launch_counts()
            out = _gpu_and_cpu(pkg, raw, "column_chunk", on_engine=on_engine)
            launches = dict(attention.launch_counts)
            res, ok = _compare_runs("uniform_reference", out)
            fields, good = extra()
            res.update(fields, launches_gpu=launches)
            emit(res)
            if not (ok and good):
                raise AssertionError("uniform_reference: GPU and CPU "
                                     "engines disagree")
            steps = res["steps"]
        chunks = len(wires["cuda"]) - steps
        want = dict(attention_fwd=steps, attention_bwd=steps,
                    attention_fwd_drop=0, attention_bwd_drop=0,
                    attention_fwd_infer=chunks)
        if launches != want:
            raise AssertionError(f"uniform_reference ({label}): launches "
                                 f"{launches}, expected {want}")


# bfloat16 compute against the CPU port: the engine tolerance of
# tests/test_torch_bf16.py, ENGINE_LOSS_TOL (one bf16 rounding step is
# 2^-8 of a value, and cuBLAS and the CPU's bf16 matmuls sum in their own
# order before it)
BF16_LOSS_TOL = 1e-3


def phase_bf16_reference(torch, pkg):
    """train.compute_dtype bfloat16 on the tiny stream at dropout 0, frozen
    and with the memory: the GPU engine (the fp32 kernels behind the bf16
    casts) against the CPU engine, per-step losses within BF16_LOSS_TOL;
    then from the CPU engine's weights and memory state the slot-unique
    val pass on both, its embedding tables in bf16, MRR within MRR_TOL.
    The dropout-0 pair once a step, the inference forward once an embed
    chunk."""
    from tgb_tgn_dgl_tpu_torch.ops import attention
    for label, raw in (("frozen", REFERENCE_RAW), ("memory", MEMORY_RAW)):
        raw = _with_train(raw, compute_dtype="bfloat16")
        runs = {}
        attention.reset_launch_counts()       # the CPU run launches none
        for dev in ("cuda", "cpu"):
            eng, losses = _recording_engine(pkg, raw, dev)
            eng.train_epoch()
            runs[dev] = (eng, losses)
        g, lg = runs["cuda"]
        c, lc = runs["cpu"]
        g.model.load_state_dict(c.model.state_dict())
        if g.use_memory:
            g.mem_state = type(c.mem_state)(*(t.to("cuda")
                                              for t in c.mem_state))
        tables = []
        counts = g._unique_counts

        def spy(emb, *args):
            tables.append(str(emb.dtype))
            return counts(emb, *args)

        g._unique_counts = spy
        mg = g.evaluate("val")
        launches = dict(attention.launch_counts)
        mc = c.evaluate("val")
        loss_err = max(abs(a - b) for a, b in zip(lg, lc))
        res = dict(phase="bf16_reference", arm=label, steps=len(lg),
                   losses_gpu=lg, losses_cpu=lc, max_loss_diff=loss_err,
                   loss_tol=BF16_LOSS_TOL, mrr_gpu=mg, mrr_cpu=mc,
                   mrr_tol=MRR_TOL, protocol=g.last_eval_trace["protocol"],
                   table_dtypes=sorted(set(tables)), launches_gpu=launches)
        emit(res)
        want = dict(attention_fwd=len(lg), attention_bwd=len(lg),
                    attention_fwd_drop=0, attention_bwd_drop=0,
                    attention_fwd_infer=g.last_eval_trace["embed_chunks"])
        if not (len(lg) == 6 and all(abs(a - b) <= BF16_LOSS_TOL * (1 + abs(b))
                                     for a, b in zip(lg, lc))
                and abs(mg - mc) <= MRR_TOL
                and res["protocol"] == "slot_unique"
                and res["table_dtypes"] == ["torch.bfloat16"]
                and launches == want):
            raise AssertionError(f"bf16_reference ({label}): GPU and CPU "
                                 f"disagree, or launches {launches} != "
                                 f"{want}")


def _fields_differ(torch, got, want):
    """Fields of two DevicePacks that differ in dtype, shape or a value
    (or where one is None, as nbr_rslot is at one layer, and the other
    not)."""
    def differ(a, b):
        if a is None or b is None:
            return a is not b
        return a.dtype != b.dtype or not torch.equal(a, b)
    return [f for f in want._fields
            if differ(getattr(got, f), getattr(want, f))]


def phase_wire(torch, data, cfg_path):
    """The native packer against the numpy packer, both fed the same
    batches in lockstep from a fresh stream state: 4 train batches as
    dedup wires and one as a compact wire (the Engine's fallback for a
    batch whose intra window exceeds 255), then
    the first 2 and the last negative chunk of the first val batch as
    eval-lean dedup wires.  Each wire goes to the card through
    ``wire_to_device`` and is expanded there; the result must equal
    ``to_device`` of the numpy pack exactly.  Host ms per batch / chunk
    of both packers (the native one with its eval-lean post-pass), which
    must stand at 1/8 or less, bytes of wire against full grids, and the
    host ms of each case's post-pass and of its ``wire_to_device``."""
    from tgb_tgn_dgl_tpu_torch.data.dependency import dependency_aware_batch
    from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
    from tgb_tgn_dgl_tpu_torch.data.packer import (PackerConfig,
                                                   StreamPacker, to_device)
    from tgb_tgn_dgl_tpu_torch.engine.negatives import (FixedNegatives,
                                                        NegLinkSamplerDest)
    from tgb_tgn_dgl_tpu_torch.engine.train import eval_neg_chunk_size
    from tgb_tgn_dgl_tpu_torch.ops.wire import (compact_wire,
                                                eval_lean_dedup, expand_any,
                                                nb_bucket_of, wire_nbytes,
                                                wire_to_device)
    from tgb_tgn_dgl_tpu_torch.utils.config import parse_config
    cfg = parse_config(cfg_path)
    B, K, N = cfg.train.batch_size, cfg.sampling.num_neighbors, data.num_nodes
    pk = PackerConfig(num_neighbors=K, batch_size=B,
                      max_intra_block=cfg.train.max_intra_block,
                      mailbox_size=cfg.memory.mailbox_size)
    plain, native = StreamPacker(N, pk), NativeStreamPacker(N, pk)
    times = torch.from_numpy(data.t.astype("float32")).cuda()
    cases, ms = [], {"numpy_train": [], "native_train": [],
                     "numpy_chunk": [], "native_chunk": []}

    def run(what, args, kw, native_pack, post=None):
        t0 = time.perf_counter()
        pack = plain.pack(*args, **kw)
        t1 = time.perf_counter()
        wire, iw = native_pack(*args, **kw)
        tp = time.perf_counter()
        if post is not None:
            wire = post(wire)
        t2 = time.perf_counter()
        dev = wire_to_device(wire, "cuda")
        t3 = time.perf_counter()
        got = expand_any(dev, K, iw, N, times)
        bad = _fields_differ(torch, got, to_device(pack, "cuda"))
        cases.append(dict(what=what, wire=type(wire).__name__,
                          eval_lean=getattr(wire, "cache_dt", 0) is None,
                          wire_bytes=wire_nbytes(wire),
                          full_bytes=wire_nbytes(pack.device()),
                          post_ms=(t2 - tp) * 1e3,
                          to_device_ms=(t3 - t2) * 1e3,
                          fields_differ=bad))
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3

    rows = data.train_mask.nonzero()[0]
    blocks = dependency_aware_batch(data.src[rows], data.dst[rows], B)
    sampler = NegLinkSamplerDest(data.unique_dst(), seed=cfg.train.seed)
    for bi in range(5):
        r, blk = rows[bi * B:(bi + 1) * B], blocks[bi * B:(bi + 1) * B]
        dst = data.dst[r]
        args = (data.src[r], dst, data.t[r], r, blk, sampler.sample(dst))
        if bi < 4:
            a, b = run(f"train batch {bi}", args, {},
                       native.pack_wire_dedup)
            ms["numpy_train"].append(a)
            ms["native_train"].append(b)
        else:
            def packed_compact(*args, **kw):
                wire, iw = native.pack_wire(*args, **kw)
                return compact_wire(wire, N, iw, pk.mailbox_size), iw
            run(f"train batch {bi}", args, {}, packed_compact)
    rows = data.val_mask.nonzero()[0]
    vblocks = dependency_aware_batch(data.src[rows], data.dst[rows], B)
    r, blk = rows[:B], vblocks[:B]
    neg, _ = FixedNegatives(data.val_ns).query_batch(0, B)
    Mc = eval_neg_chunk_size(cfg, neg.shape[1], B)
    n_chunks = -(-neg.shape[1] // Mc)
    nbb = nb_bucket_of(vblocks)
    for ci in (0, 1, n_chunks - 1):
        last = ci == n_chunks - 1
        args = (data.src[r], data.dst[r], data.t[r], r, blk,
                neg[:, ci * Mc:(ci + 1) * Mc])
        a, b = run(f"val chunk {ci} of {n_chunks}", args,
                   dict(eval_mode=True, insert=last, write_mail=last),
                   native.pack_wire_dedup,
                   post=lambda w: eval_lean_dedup(w, blk, nbb))
        ms["numpy_chunk"].append(a)
        ms["native_chunk"].append(b)
    med = {k: statistics.median(v) for k, v in ms.items()}
    ratio = {k: med[f"native_{k}"] / med[f"numpy_{k}"]
             for k in ("train", "chunk")}
    emit(dict(phase="wire", cases=cases, host_ms=ms,
              median_host_ms=med, native_over_numpy=ratio,
              max_ratio=1 / 8, chunk_negatives=Mc,
              host_ms_is="the chip machine's CPU, this call"))
    bad = [c["what"] for c in cases if c["fields_differ"]]
    if bad:
        raise AssertionError(f"device expansion differs from the numpy "
                             f"pack: {bad}")
    if not (cases[0]["wire"] == "DedupWire"
            and cases[4]["wire"] == "CompactWire"
            and all(c["eval_lean"] for c in cases[5:])):
        raise AssertionError(f"unexpected wire formats: {cases}")
    slow = [k for k, v in ratio.items() if v > 1 / 8]
    if slow:
        raise AssertionError(f"native packer over 1/8 of the numpy "
                             f"packer's time: {slow} {ratio}")


def phase_layer2_wire(torch, data, cfg_path):
    """phase_wire at layers=2 (configs/TGN-2layer.yml): the native packer's
    ``pack_wire`` and the numpy packer in lockstep from a fresh state, 4
    train batches and the first 2 negative chunks of the first val batch,
    each narrowed by ``compact_wire`` as the Engine ships it at
    gnn.layer > 1, copied to the card by ``wire_to_device`` (the u16 rslot
    sentinel arrives as 65535) and expanded there: equal to ``to_device``
    of the numpy pack in every field, nbr_rslot included."""
    from tgb_tgn_dgl_tpu_torch.data.dependency import dependency_aware_batch
    from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
    from tgb_tgn_dgl_tpu_torch.data.packer import (PackerConfig,
                                                   StreamPacker, to_device)
    from tgb_tgn_dgl_tpu_torch.engine.negatives import (FixedNegatives,
                                                        NegLinkSamplerDest)
    from tgb_tgn_dgl_tpu_torch.engine.train import eval_neg_chunk_size
    from tgb_tgn_dgl_tpu_torch.ops.wire import (compact_wire, expand_any,
                                                wire_nbytes, wire_to_device)
    from tgb_tgn_dgl_tpu_torch.utils.config import parse_config
    cfg = parse_config(cfg_path)
    B, K, N = cfg.train.batch_size, cfg.sampling.num_neighbors, data.num_nodes
    pk = PackerConfig(num_neighbors=K, batch_size=B,
                      max_intra_block=cfg.train.max_intra_block,
                      mailbox_size=cfg.memory.mailbox_size,
                      layers=cfg.gnn.layer)
    plain, native = StreamPacker(N, pk), NativeStreamPacker(N, pk)
    cases = []

    def run(what, args, kw):
        pack = plain.pack(*args, **kw)
        t0 = time.perf_counter()
        wire, iw = native.pack_wire(*args, **kw)
        cw = compact_wire(wire, N, iw, pk.mailbox_size)
        t1 = time.perf_counter()
        got = expand_any(wire_to_device(cw, "cuda"), K, iw, N)
        want = to_device(pack, "cuda")
        cases.append(dict(
            what=what, wire=type(cw).__name__,
            rslot_dtype=str(cw.cache_rslot.dtype),
            rslot_in_block=int((got.nbr_rslot >= 0).sum()
                               - pack.num_real_roots),
            wire_bytes=wire_nbytes(cw), full_bytes=wire_nbytes(pack.device()),
            native_ms=(t1 - t0) * 1e3,
            fields_differ=_fields_differ(torch, got, want)))

    rows = data.train_mask.nonzero()[0]
    blocks = dependency_aware_batch(data.src[rows], data.dst[rows], B)
    sampler = NegLinkSamplerDest(data.unique_dst(), seed=cfg.train.seed)
    for bi in range(4):
        r, blk = rows[bi * B:(bi + 1) * B], blocks[bi * B:(bi + 1) * B]
        dst = data.dst[r]
        run(f"train batch {bi}",
            (data.src[r], dst, data.t[r], r, blk, sampler.sample(dst)), {})
    rows = data.val_mask.nonzero()[0]
    vblocks = dependency_aware_batch(data.src[rows], data.dst[rows], B)
    r, blk = rows[:B], vblocks[:B]
    neg, _ = FixedNegatives(data.val_ns).query_batch(0, B)
    Mc = eval_neg_chunk_size(cfg, neg.shape[1], B)
    for ci in (0, 1):
        run(f"val chunk {ci}", (data.src[r], data.dst[r], data.t[r], r, blk,
                                neg[:, ci * Mc:(ci + 1) * Mc]),
            dict(eval_mode=True, insert=False, write_mail=False))
    emit(dict(phase="layer2_wire", layers=pk.layers, cases=cases,
              host_ms_is="the chip machine's CPU, this call"))
    bad = [c["what"] for c in cases if c["fields_differ"]]
    if bad:
        raise AssertionError(f"layer-2 expansion differs from the numpy "
                             f"pack: {bad}")
    if not all(c["wire"] == "CompactWire" and c["rslot_dtype"] == "uint16"
               and c["rslot_in_block"] > 0 for c in cases):
        raise AssertionError(f"unexpected layer-2 wires: {cases}")


def _timed_first_step(torch, eng):
    """Wrap ``eng._train_step`` so that a CUDA event is recorded after the
    first step; nothing waits for the device inside the epoch.  The caller
    records ``rec["start"]`` just before ``train_epoch`` and, once the
    epoch has been synchronized, ``_train_times`` reads the first step's
    time from the start event to the end of its device work."""
    rec = {"start": torch.cuda.Event(enable_timing=True)}
    step = eng._train_step

    def timed(pack, acc):
        out = step(pack, acc)
        if "first" not in rec:
            rec["first"] = torch.cuda.Event(enable_timing=True)
            rec["first"].record()
        return out

    eng._train_step = timed
    return rec


def _train_times(stats, tr, rec, batch):
    first = rec["start"].elapsed_time(rec["first"]) / 1e3
    rest = tr["total_s"] - first
    return dict(seconds=tr["total_s"], pack_s=tr["pack_s"],
                fetch_s=tr["fetch_s"], copy_s=tr["copy_s"],
                disp_s=tr["disp_s"],
                edges_per_s=stats["events"] / tr["total_s"],
                first_step_s=first,
                after_first_step_edges_per_s=(stats["events"] - batch)
                / max(rest, 1e-9))


def engine_step_shapes(eng) -> dict:
    """``flagship_step_cost``'s arguments for one train step of ``eng``
    (TGN at one layer, scalar messages, the host packer), from the shapes
    its packer padded the epoch's batches to: the sticky root bucket R
    and, with the memory, the unique-node bucket Ub of the train key
    (M = 1, not eval), and the intra width P (``max_intra_block``, or the
    sticky bucket P where no cap is set), Kp = K + 1 + P.  The
    counterpart of bench.py::_engine_cost without its default shapes: a
    packer that has padded no train batch raises."""
    from tgb_tgn_dgl_tpu_torch.utils.flops import count_params
    cfg = eng.config
    buckets = eng.packer.bucket_state().get((1, False), {})
    cap = cfg.train.max_intra_block
    if "R" not in buckets or "Ub" not in buckets or (
            cap is None and "P" not in buckets):
        raise AssertionError(f"the engine's packer holds no train bucket "
                             f"({buckets})")
    P = cap if cap is not None else buckets["P"]
    return dict(B=cfg.train.batch_size, R=buckets["R"],
                Kp=cfg.sampling.num_neighbors + 1 + P, F=eng.data.msg_dim,
                D=cfg.gnn.dim_out, H=cfg.gnn.att_head, M=1,
                U=0 if cfg.train.frozen_memory else buckets["Ub"],
                S=cfg.memory.mailbox_size, updater=cfg.memory.memory_update,
                n_params=count_params(eng.model), train=True,
                act_bytes=2 if cfg.train.compute_dtype == "bfloat16" else 4)


def roofline(torch, shapes, compute_dtype, edges_per_s) -> dict:
    """The train step's roofline reading at a measured rate: achieved
    TFLOP/s, the share of the card's peak FLOP/s for ``compute_dtype``
    (MFU) and of its HBM rate, from ``engine_step_shapes``' ``shapes``;
    the peaks it was read against and the card's nvidia-smi name and
    power limit beside them.  float32 is read against the peak outside
    the tensor cores, so TF32 must be off."""
    from tgb_tgn_dgl_tpu_torch.utils.flops import (H100_PEAK_HBM_BPS,
                                                   flagship_step_cost,
                                                   mfu_report,
                                                   peak_flops_for)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: float32's peak would be TF32's")
    cost = flagship_step_cost(**shapes)
    peak = peak_flops_for(compute_dtype)
    return dict(mfu_report(edges_per_s, cost, shapes["B"], peak_flops=peak,
                           peak_bps=H100_PEAK_HBM_BPS),
                roofline_at_edges_per_s=edges_per_s, peak_flops=peak,
                peak_bps=H100_PEAK_HBM_BPS, step_flops=cost["flops"],
                step_bytes=cost["bytes"],
                step_shapes={k: shapes[k] for k in ("R", "Kp", "U",
                                                    "n_params", "act_bytes")},
                nvidia_smi=nvidia_smi_line())


def phase_train(torch, pkg, data, cfg_path):
    import dataclasses
    cfg = pkg.parse_config(cfg_path)
    cfg.train.sanity_batches = 0
    eng = pkg.Engine(data, cfg)
    rec = _timed_first_step(torch, eng)
    torch.cuda.synchronize()
    rec["start"].record()
    stats = eng.train_epoch()
    torch.cuda.synchronize()
    tr = eng.last_epoch_trace
    times = _train_times(stats, tr, rec, cfg.train.batch_size)
    cfg0 = dataclasses.replace(
        cfg, gnn=dataclasses.replace(cfg.gnn, override_dropout=0.0),
        train=dataclasses.replace(cfg.train, sanity_batches=2))
    eng0 = pkg.Engine(data, cfg0)
    stats0 = eng0.train_epoch()
    tr0 = eng0.last_epoch_trace
    res = dict(phase="train", events=stats["events"], steps=tr["batches"],
               loss_sum=stats["loss"], ap=stats["ap"], auc=stats["auc"],
               **times, **roofline(torch, engine_step_shapes(eng),
                                   cfg.train.compute_dtype,
                                   times["edges_per_s"]),
               dropout0_steps=tr0["batches"], dropout0_loss_sum=stats0["loss"],
               dropout0_ap=stats0["ap"], dropout0_auc=stats0["auc"],
               dropout0_seconds=tr0["total_s"],
               dropout0_pack_s=tr0["pack_s"], dropout0_disp_s=tr0["disp_s"],
               width=dict(D=cfg.gnn.dim_out, H=cfg.gnn.att_head,
                          K=cfg.sampling.num_neighbors,
                          batch=cfg.train.batch_size, msg=data.msg_dim),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit(res)
    import math
    if not (math.isfinite(stats["loss"]) and math.isfinite(stats0["loss"])):
        raise AssertionError("non-finite training loss")
    return eng, res


def phase_memory_train(torch, pkg, data, cfg_path, phase="memory_train",
                       steps=0, **gnn):
    """TGN-memory.yml (or another memory config) at full width: the full
    train split (or its first ``steps`` batches) at dropout 0.2 through
    apply_mail → embed → loss → backward → commit; ``gnn`` overrides keys
    of the config's gnn section.  The memory_train phase (TGN-memory.yml
    itself) adds the step's roofline reading at its edges/s."""
    import dataclasses
    import math
    cfg = pkg.parse_config(cfg_path)
    cfg.train.sanity_batches = steps
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, **gnn))
    torch.cuda.reset_peak_memory_stats()
    eng = pkg.Engine(data, cfg)
    rec = _timed_first_step(torch, eng)
    torch.cuda.synchronize()
    rec["start"].record()
    stats = eng.train_epoch()
    torch.cuda.synchronize()
    tr = eng.last_epoch_trace
    st = eng.mem_state
    nonzero = int((st.mem.abs().sum(1) > 0).sum())
    times = _train_times(stats, tr, rec, cfg.train.batch_size)
    if phase == "memory_train":
        times.update(roofline(torch, engine_step_shapes(eng),
                              cfg.train.compute_dtype, times["edges_per_s"]))
    res = dict(phase=phase, events=stats["events"],
               steps=tr["batches"], loss_sum=stats["loss"], ap=stats["ap"],
               auc=stats["auc"], **times,
               mem_nonzero_rows=nonzero,
               valid_mail=int(st.mail_valid.sum()),
               width=dict(arch=cfg.gnn.arch, D=cfg.gnn.dim_out,
                          H=cfg.gnn.att_head, K=cfg.sampling.num_neighbors,
                          layers=cfg.gnn.layer,
                          message_mode=cfg.gnn.message_mode,
                          batch=cfg.train.batch_size, msg=data.msg_dim,
                          dropout=[cfg.train.dropout, cfg.train.att_dropout],
                          memory_dim=eng.mem_cfg.memory_dim,
                          # the cell's input: the lazy message, or DyRep's
                          # stored mail
                          cell_input=getattr(eng.mem_cfg, "mail_dim", None)
                          or eng.mem_cfg.msg_dim,
                          mailbox=cfg.memory.mailbox_size,
                          updater=eng.mem_cfg.updater),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit(res)
    if not math.isfinite(stats["loss"]):
        raise AssertionError("non-finite memory training loss")
    if nonzero == 0:
        raise AssertionError("the memory is still all zeros after training")
    return eng, res


def _eval_record(tr):
    """The eval trace's protocol, counts and host times."""
    return {k: tr[k] for k in ("protocol", "batches", "embed_chunks",
                               "score_chunks", "chunks", "pack_s", "fetch_s",
                               "copy_s", "disp_s")}


def _val_pass(torch, eng, run=None):
    """One full val pass, by ``eng.evaluate`` or ``run``: (MRR, wall
    seconds, the trace's record, peak device memory in GiB during the
    pass)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mrr = (run or eng.evaluate)("val")
    torch.cuda.synchronize()
    return (mrr, time.perf_counter() - t0, _eval_record(eng.last_eval_trace),
            torch.cuda.max_memory_allocated() / 2**30)


def phase_eval(torch, eng, phase="eval", closed_by=None):
    """The streaming val pass with every negative, by the default gate,
    which must open (the slot-unique protocol), or with ``closed_by`` must
    close for that reason (the column-chunk protocol).  Returns its MRR
    and record."""
    mrr, seconds, rec, peak = _val_pass(torch, eng)
    res = dict(phase=phase, split="val",
               negatives=int(eng.data.val_ns.shape[1]),
               events=int(eng.data.val_mask.sum()), mrr=mrr,
               seconds=seconds, **rec, peak_mem_gb=peak,
               gate_closed_by=sorted(eng._eval_gate_logged))
    emit(res)
    if not 0.0 < mrr <= 1.0:
        raise AssertionError(f"val MRR {mrr} outside (0, 1]")
    want = "slot_unique" if closed_by is None else "column_chunk"
    if rec["protocol"] != want or res["gate_closed_by"] != (
            [] if closed_by is None else [closed_by]):
        raise AssertionError(f"the default val pass took the "
                             f"{rec['protocol']} protocol, the gate closed "
                             f"by {res['gate_closed_by']}")
    return res


# the 'uniform' arm's val pass: its first batch only (its numpy packs of
# 46 column chunks take a second each on the host, PERF.md)
UNIFORM_VAL_BATCHES = 1


def _full_width(pkg, cfg_path, **train):
    """A config file with ``train`` keys replaced, the whole train split."""
    cfg = pkg.parse_config(cfg_path)
    for k, v in dict(train, sanity_batches=0).items():
        setattr(cfg.train, k, v)
    return cfg


def _train_arm(torch, pkg, data, cfg):
    """A fresh engine of ``cfg`` trained one epoch: (engine, stats, trace
    record, peak GiB of the engine's build and epoch above what was
    allocated before it).  Engines of earlier arms that only a reference
    cycle still holds are collected first; the record's
    ``held_before_gb`` is what stayed allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = pkg.Engine(data, cfg)
    rec = _timed_first_step(torch, eng)
    torch.cuda.synchronize()
    rec["start"].record()
    stats = eng.train_epoch()
    torch.cuda.synchronize()
    times = _train_times(stats, eng.last_epoch_trace, rec,
                         cfg.train.batch_size)
    return (eng, stats, dict(times, steps=eng.last_epoch_trace["batches"],
                             held_before_gb=held / 2**30),
            (torch.cuda.max_memory_allocated() - held) / 2**30)


def phase_uniform_train(torch, pkg, attention, data, cfg_path, recent):
    """configs/TGN.yml with sampling.strategy 'uniform' at full width: the
    whole train split (56 steps at dropout 0.2), every batch packed on the
    main thread by the numpy packer with the t-CSR (``fetch_s`` is that
    whole pack), then the val pass by column chunks (the gate closes) over
    its first UNIFORM_VAL_BATCHES batches with all 999 negatives.  Beside
    the 'recent' arm of this call (``recent``: the train phase's record and
    the frozen column-chunk val pass).  Returns the launches (the dropout
    pair once a step, the inference forward once a chunk) and the
    expected ones."""
    import itertools
    import math

    from tgb_tgn_dgl_tpu_torch.engine.train import UNIFORM_GATE
    reset_counts(attention)
    cfg = _full_width(pkg, cfg_path)
    cfg.sampling.strategy = "uniform"
    t0 = time.perf_counter()
    eng, stats, tr, peak = _train_arm(torch, pkg, data, cfg)
    batches = eng._iter_batches

    def first_val_batches(split):
        it = batches(split)
        return itertools.islice(it, UNIFORM_VAL_BATCHES) if split == "val" \
            else it

    eng._iter_batches = first_val_batches
    mrr, seconds, erec, vpeak = _val_pass(torch, eng)
    counts = counts_now(attention)
    train_rec, chunked = recent
    res = dict(phase="uniform_train", strategy="uniform",
               events=stats["events"], loss_sum=stats["loss"],
               ap=stats["ap"], auc=stats["auc"], **tr, peak_mem_gb=peak,
               val_batches=erec["batches"], val_chunks=erec["chunks"],
               val_seconds=seconds,
               val_seconds_per_chunk=seconds / max(erec["chunks"], 1),
               val_fetch_s=erec["fetch_s"], val_disp_s=erec["disp_s"],
               val_mrr_first_batches=mrr,
               val_peak_mem_gb=vpeak - tr["held_before_gb"],
               gate_closed_by=sorted(eng._eval_gate_logged),
               phase_s=time.perf_counter() - t0, launches=counts,
               recent=dict(edges_per_s=train_rec["edges_per_s"],
                           fetch_s=train_rec["fetch_s"],
                           disp_s=train_rec["disp_s"],
                           peak_mem_gb=train_rec["peak_mem_gb"],
                           loss_sum=train_rec["loss_sum"],
                           column_chunk_seconds_per_chunk=chunked[
                               "seconds_column_chunk"] / chunked[
                               "column_chunk"]["chunks"]))
    res["edges_per_s_vs_recent"] = (res["edges_per_s"]
                                    / train_rec["edges_per_s"])
    emit(res)
    want = dict(attention_fwd=0, attention_bwd=0,
                attention_fwd_drop=tr["steps"], attention_bwd_drop=tr["steps"],
                attention_fwd_infer=erec["embed_chunks"], gather_bwd=0)
    if not (math.isfinite(stats["loss"]) and 0.0 < mrr <= 1.0
            and erec["protocol"] == "column_chunk"
            and res["gate_closed_by"] == [UNIFORM_GATE]):
        raise AssertionError("uniform_train: a non-finite loss, an MRR "
                             "outside (0, 1] or another protocol")
    return counts, want


def phase_bf16_train(torch, pkg, attention, data, paths):
    """configs/TGN.yml and configs/TGN-memory.yml at full width, each with
    compute_dtype float32 and bfloat16 in this call, in turns (float32,
    bfloat16, bfloat16, float32): the whole train split at the config's
    dropout, and after each dtype's first epoch the slot-unique val pass
    (bf16: its embedding table in bf16).  Edges/s, disp_s and peak
    memory of all four epochs (each peak above what was allocated before
    its engine, ``_train_arm``; the val pass's too), the loss sum and the
    val MRR; fails only on a
    non-finite loss or MRR (a full-width MRR bound would sit inside the
    trajectory's own noise, PERF.md).  Each dtype's record carries the
    step's roofline reading at the mean edges/s of its two epochs, read
    against that dtype's peak.  Returns each bf16 arm's launches (its
    first epoch and val pass) and, as expected, its float32 arm's."""
    import math
    counts, want = {}, {}
    for label, cfg_path in paths:
        arms, shapes = {}, {}
        for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
            reset_counts(attention)
            cfg = _full_width(pkg, cfg_path, compute_dtype=dtype)
            eng, stats, tr, peak = _train_arm(torch, pkg, data, cfg)
            if dtype in arms:               # the second epoch: its speed
                arms[dtype]["edges_per_s_again"] = tr["edges_per_s"]
                arms[dtype]["disp_s_again"] = tr["disp_s"]
                arms[dtype]["peak_mem_gb_again"] = peak
                del eng
                continue
            mrr, seconds, erec, vpeak = _val_pass(torch, eng)
            shapes[dtype] = engine_step_shapes(eng)
            arms[dtype] = dict(loss_sum=stats["loss"], **tr,
                               peak_mem_gb=peak, val_mrr=mrr,
                               val_seconds=seconds,
                               val_peak_mem_gb=vpeak - tr["held_before_gb"],
                               val_protocol=erec["protocol"],
                               embed_chunks=erec["embed_chunks"],
                               launches=counts_now(attention))
            del eng
        counts[f"bf16_{label}"] = arms["bfloat16"]["launches"]
        want[f"bf16_{label}"] = arms["float32"]["launches"]
        b, f = arms["bfloat16"], arms["float32"]

        def mean_rate(a):
            return (a["edges_per_s"] + a["edges_per_s_again"]) / 2

        for dtype, a in arms.items():
            a.update(roofline(torch, shapes[dtype], dtype, mean_rate(a)))
        emit(dict(phase="bf16_train", arm=label, float32=f, bfloat16=b,
                  edges_per_s_vs_float32=mean_rate(b) / mean_rate(f),
                  peak_vs_float32=(b["peak_mem_gb"] + b["peak_mem_gb_again"])
                  / (f["peak_mem_gb"] + f["peak_mem_gb_again"]),
                  val_seconds_vs_float32=b["val_seconds"] / f["val_seconds"]))
        if not all(math.isfinite(a["loss_sum"]) and 0.0 < a["val_mrr"] <= 1.0
                   for a in arms.values()):
            raise AssertionError(f"bf16_train ({label}): a non-finite loss "
                                 f"or an MRR outside (0, 1]")
    return counts, want


def phase_remat_train(torch, pkg, attention, data, cfg_path):
    """configs/TGN-memory.yml at full width with train.remat off and on in
    this call, in turns (off, on, on, off), all under deterministic
    algorithms: after the whole train split (dropout 0.2) the parameters
    and every MemoryState field of the first two must be bit-equal.  Peak
    memory (above what was allocated before each engine, ``_train_arm``)
    and edges/s of all four; the remat arm launches
    attention_fwd_drop twice a step (the forward and the recompute) and
    attention_bwd_drop once.  Returns its launches and the expected."""
    arms = {}
    torch.use_deterministic_algorithms(True)
    try:
        for remat in (False, True, True, False):
            reset_counts(attention)
            cfg = _full_width(pkg, cfg_path, remat=remat)
            eng, stats, tr, peak = _train_arm(torch, pkg, data, cfg)
            if remat in arms:               # the second epoch: its speed
                arms[remat][1].update(edges_per_s_again=tr["edges_per_s"],
                                      peak_mem_gb_again=peak)
                del eng
                continue
            # the state on the host, so that no tensor of this engine
            # outlives it into the next arm's peak
            state = ({k: v.cpu() for k, v in eng.model.state_dict().items()},
                     {f: t.cpu() for f, t in eng.mem_state._asdict().items()})
            arms[remat] = (state, dict(loss_sum=stats["loss"], **tr,
                                       peak_mem_gb=peak,
                                       launches=counts_now(attention)))
            del eng
    finally:
        torch.use_deterministic_algorithms(False)
    (off, roff), (on, ron) = arms[False], arms[True]
    params = [k for k in off[0] if not torch.equal(off[0][k], on[0][k])]
    memory = [f for f in off[1] if not torch.equal(off[1][f], on[1][f])]
    steps = ron["steps"]
    want = dict(attention_fwd=0, attention_bwd=0,
                attention_fwd_drop=2 * steps, attention_bwd_drop=steps,
                attention_fwd_infer=0, gather_bwd=2 * steps)
    emit(dict(phase="remat_train", remat_off=roff, remat_on=ron,
              unequal_params=params, unequal_memory_fields=memory,
              peak_vs_off=(ron["peak_mem_gb"] + ron["peak_mem_gb_again"])
              / (roff["peak_mem_gb"] + roff["peak_mem_gb_again"]),
              edges_per_s_vs_off=(ron["edges_per_s"] + ron["edges_per_s_again"])
              / (roff["edges_per_s"] + roff["edges_per_s_again"])))
    if params or memory or roff["loss_sum"] != ron["loss_sum"]:
        raise AssertionError(f"remat_train: remat differs from no remat "
                             f"({params}, {memory})")
    return ron["launches"], want


def _stream_state(eng):
    """The engine's stream state: the packer's arrays and, with the
    memory, a copy of the MemoryState."""
    mem = (None if eng.mem_state is None else
           type(eng.mem_state)(*(t.clone() for t in eng.mem_state)))
    return eng.packer.snapshot(), mem


def _unequal_packer_arrays(a, b):
    """Indices of the packer snapshot arrays that differ."""
    import numpy as np
    return [i for i, (x, y) in enumerate(zip(a, b))
            if not np.array_equal(x, y)]


def phase_eval_unique_vs_chunked(torch, eng, snap, unique, phase):
    """The val pass of ``phase_eval`` (slot-unique, from the stream state
    ``snap`` taken before it; ``unique`` its record) against the
    column-chunk pass from the same state: MRRs within MRR_TOL, the packer
    states after both passes equal and, with the memory, the MemoryStates
    too (mem within MEM_TOL, the rest exactly).  Times both protocols."""
    packer_unique, after_unique = _stream_state(eng)
    eng.packer.restore(snap[0])
    if snap[1] is not None:
        eng.mem_state = snap[1]
    mrr, seconds, rec, peak = _val_pass(torch, eng, eng._evaluate_chunked)
    unequal = _unequal_packer_arrays(packer_unique, eng.packer.snapshot())
    res = dict(phase=phase, mrr_slot_unique=unique["mrr"],
               mrr_column_chunk=mrr, mrr_tol=MRR_TOL,
               seconds_slot_unique=unique["seconds"],
               seconds_column_chunk=seconds,
               unequal_packer_arrays=unequal,
               column_chunk=dict(rec, peak_mem_gb=peak),
               slot_unique={k: unique[k] for k in rec})
    ok = rec["protocol"] == "column_chunk" and abs(mrr - unique["mrr"]) \
        <= MRR_TOL and not unequal
    if after_unique is not None:
        diff, same = _state_diff(torch, after_unique, eng.mem_state)
        res.update(diff)
        ok = ok and same
    emit(res)
    if not ok:
        raise AssertionError("the slot-unique and column-chunk val passes "
                             "disagree")
    return res


# a stream of tgbl-review's node count and negatives, cut in events
LOW_DEDUP_EDGES = 70_000
JAX_AUTO_MIN = 1.5


def _jax_auto_estimate(eng, split):
    """The per-block candidate dedup that the JAX Engine's "auto" gate
    estimates for ``split`` (tgb_tgn_dgl_tpu engine/train.py:739-751);
    under JAX_AUTO_MIN that engine evaluates by column chunks."""
    import math
    blocks = eng.blocks_for(split)
    M = eng.data.val_ns.shape[1]
    draws = (2 + M) * eng.config.train.batch_size / (int(blocks.max()) + 1)
    N = eng.data.num_nodes
    return draws / max(N * (1.0 - math.exp(-draws / N)), 1.0)


def phase_eval_low_dedup(torch, pkg, cfg_path):
    """configs/TGN.yml on a stream with tgbl-review's node count and
    negatives (352,637 nodes, 100 a row) cut to LOW_DEDUP_EDGES events,
    where the JAX "auto" estimate is under JAX_AUTO_MIN: one train epoch,
    then the val pass by the default gate, which must open, and by column
    chunks from the same stream state.  MRRs within MRR_TOL, the packer
    states after both passes equal, and both times."""
    data = pkg.synthetic("tgbl-review", num_edges=LOW_DEDUP_EDGES)
    eng = pkg.Engine(data, pkg.parse_config(cfg_path))
    eng.train_epoch()
    snap = eng.packer.snapshot()
    est = _jax_auto_estimate(eng, "val")
    mrr_u, sec_u, rec_u, peak_u = _val_pass(torch, eng)
    packer_unique = eng.packer.snapshot()
    eng.packer.restore(snap)
    mrr_c, sec_c, rec_c, peak_c = _val_pass(torch, eng,
                                            eng._evaluate_chunked)
    unequal = _unequal_packer_arrays(packer_unique, eng.packer.snapshot())
    emit(dict(phase="eval_low_dedup", nodes=data.num_nodes,
              negatives=int(data.val_ns.shape[1]),
              events=int(data.val_mask.sum()), jax_auto_estimate=est,
              mrr_slot_unique=mrr_u, mrr_column_chunk=mrr_c,
              mrr_tol=MRR_TOL, seconds_slot_unique=sec_u,
              seconds_column_chunk=sec_c, unequal_packer_arrays=unequal,
              slot_unique=dict(rec_u, peak_mem_gb=peak_u),
              column_chunk=dict(rec_c, peak_mem_gb=peak_c)))
    if est >= JAX_AUTO_MIN:
        raise AssertionError(f"the JAX auto estimate {est} would open its "
                             f"gate: the stream is not the one meant")
    if rec_u["protocol"] != "slot_unique" or not 0.0 < mrr_u <= 1.0:
        raise AssertionError(f"the default val pass took "
                             f"{rec_u['protocol']} (MRR {mrr_u})")
    if abs(mrr_u - mrr_c) > MRR_TOL or unequal:
        raise AssertionError("the slot-unique and column-chunk val passes "
                             "disagree")


# ConvTransE at RE-GCN's width (embedding 200, 50 channels, kernel 3)
DECODER_SHAPES = dict(D=200, channels=50, kernel=3, entities=10_000,
                      queries=1_000, candidates=100)
DECODER_TOL = 1e-4


def phase_decoders(torch):
    """The decoder heads (models/decoders.py, plain torch) on the GPU
    against the CPU from the same parameters and inputs: the link
    predictor with (B, D) and (B, M, D) destinations, the node predictor,
    and ConvTransE's scores in eval mode and in two train calls at dropout
    0, then its running statistics; all within DECODER_TOL abs+rel.  Then
    the device time of each call on the GPU (``time_ms``; the train calls
    go on moving the running statistics, after the comparison)."""
    from tgb_tgn_dgl_tpu_torch.models import decoders
    sh = DECODER_SHAPES
    D, Q, M = sh["D"], sh["queries"], sh["candidates"]
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    link = decoders.LinkPredictor(D, generator=g)
    node = decoders.NodePredictor(D, 20, generator=g)
    conv = decoders.ConvTransE(D, sh["channels"], sh["kernel"], generator=g)
    ent, sub, rel = randn(sh["entities"], D), randn(Q, D), randn(Q, D)
    cand = randn(Q, M, D)
    drop0 = dict(input_drop=0.0, hidden_drop=0.0, feature_drop=0.0)
    calls = {
        "link_BD": lambda m, x: m["link"](x["sub"], x["rel"]),
        "link_BMD": lambda m, x: m["link"](x["sub"], x["cand"]),
        "node": lambda m, x: m["node"](x["sub"]),
        "conv_transe_eval": lambda m, x: m["conv"](
            x["ent"], x["sub"], x["rel"], train=False),
        "conv_transe_train_1": lambda m, x: m["conv"](
            x["ent"], x["sub"], x["rel"], train=True, **drop0),
        "conv_transe_train_2": lambda m, x: m["conv"](
            x["ent"], x["rel"], x["sub"], train=True, **drop0)}
    runs = {}
    for dev in ("cuda", "cpu"):
        mods = {k: copy.deepcopy(v).to(dev) for k, v in
                dict(link=link, node=node, conv=conv).items()}
        xs = {k: v.to(dev) for k, v in
              dict(ent=ent, sub=sub, rel=rel, cand=cand).items()}
        with torch.no_grad():
            outs = {name: call(mods, xs).cpu()
                    for name, call in calls.items()}
        runs[dev] = (outs, {n: b.cpu() for n, b in
                            mods["conv"].named_buffers()}, mods, xs)
    (og, bg, mods, xs), (oc, bc, _, _) = runs["cuda"], runs["cpu"]
    errs = {n: _err(og[n], oc[n])[0] for n in calls}
    errs.update({f"bn_{n}": _err(bg[n], bc[n])[0] for n in bc})
    ok = all(bool(((og[n] - oc[n]).abs() <= DECODER_TOL
                   + DECODER_TOL * oc[n].abs()).all()) for n in calls) \
        and all(bool(((bg[n] - bc[n]).abs() <= DECODER_TOL
                      + DECODER_TOL * bc[n].abs()).all()) for n in bc)
    finite = all(bool(torch.isfinite(o).all()) for o in og.values())
    moved = not torch.equal(bc["bn2.var"], torch.ones(D))
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    with torch.no_grad():
        ms = {name: time_ms(torch, lambda c=call: c(mods, xs), flush)
              for name, call in calls.items()}
    emit(dict(phase="decoders", shapes=sh, max_abs_err=errs,
              tol=DECODER_TOL, gpu_ms=ms))
    if not (ok and finite and moved):
        raise AssertionError(f"decoders: GPU and CPU disagree: {errs}")


RAGGED_NEG = 24


def phase_pad_mask(torch, pkg):
    """A tiny stream whose rows of 24 negatives are cut to a seeded length
    in 1..24, evaluated with eval_neg_mode pad_mask and hits@10 after one
    train epoch, on the GPU and on the CPU from the same weights, by both
    protocols from the same stream state: val then test within MRR_TOL of
    the CPU, and each GPU val pass waits for the device at most once."""
    import dataclasses

    import numpy as np
    base = _tiny(pkg, RAGGED_NEG)

    def cut(ns, seed):
        rng = np.random.default_rng(seed)
        out = np.empty(len(ns), object)
        for i, row in enumerate(ns):
            out[i] = row[:int(rng.integers(1, ns.shape[1] + 1))]
        return out

    data = dataclasses.replace(base, val_ns=cut(base.val_ns, 7),
                               test_ns=cut(base.test_ns, 8),
                               eval_metric="hits@10")
    raw = dict(REFERENCE_RAW, train=[dict(REFERENCE_RAW["train"][0],
                                          eval_neg_mode="pad_mask")])
    got, syncs = {}, {}
    for dev in ("cuda", "cpu"):
        eng = pkg.Engine(data, pkg.parse_config_dict(raw), device=dev)
        eng.train_epoch()
        snap = eng.packer.snapshot()
        for run in (eng.evaluate, eng._evaluate_chunked):
            eng.packer.restore(snap)
            val = {}
            if dev == "cuda":
                sites = _sync_sites(torch, lambda: val.update(v=run("val")))
                syncs[eng.last_eval_trace["protocol"]] = sorted(sites)
            else:
                val["v"] = run("val")
            proto = eng.last_eval_trace["protocol"]
            got[dev, proto] = (val["v"], run("test"))
    diffs = {p: max(abs(a - b) for a, b in zip(got["cuda", p],
                                               got["cpu", p]))
             for p in ("slot_unique", "column_chunk")}
    emit(dict(phase="pad_mask", metric="hits@10", negatives="1..24",
              hits_gpu={p: got["cuda", p] for p in diffs},
              hits_cpu={p: got["cpu", p] for p in diffs},
              max_diff=diffs, tol=MRR_TOL,
              val_syncs={p: len(v) for p, v in syncs.items()},
              sync_sites=syncs))
    if max(diffs.values()) > MRR_TOL:
        raise AssertionError(f"pad_mask GPU and CPU disagree: {diffs}")
    if any(len(v) > 1 for v in syncs.values()) or len(syncs) != 2:
        raise AssertionError(f"a pad_mask val pass waited for the device "
                             f"more than once: {syncs}")


# ------------------------------------------------- the training entry point
FIT_EPOCHS = 2
FIT_PATIENCE = 5
RESUME_TEST_TOL = 1e-6        # same state and parameters: same ranks
WIKI_TRAIN_STEPS = 56         # 110,232 train events in batches of 2000


def phase_fit_reference(torch, pkg, tmp):
    """``Engine.fit`` on the tiny stream with the memory at dropout 0 (so
    attention_fwd and attention_bwd run), two epochs with the val
    snapshot, a checkpoint an epoch and early stopping, on the GPU and on
    the CPU from the same weights: per-step losses within LOSS_TOL, the
    epoch losses (Σ loss·n) within LOSS_TOL relative, val MRRs within
    MRR_TOL.  Then a GPU engine resumed from the epoch-1 checkpoint fits
    one epoch: its epoch-2 loss and val MRR equal the uninterrupted GPU
    run's (the train step adds with no atomics, and the checkpoint keeps
    the packer's padded shapes)."""
    from tgb_tgn_dgl_tpu_torch.engine.checkpoint import EarlyStopMonitor
    from tgb_tgn_dgl_tpu_torch.ops import attention
    runs = {}
    attention.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        eng, steps = _recording_engine(pkg, MEMORY_RAW, dev)
        ckpt_dir = os.path.join(tmp, f"fit_reference_{dev}")
        hist = eng.fit(epochs=FIT_EPOCHS, log=lambda line: None,
                       val_snapshot=True, checkpoint_dir=ckpt_dir,
                       checkpoint_every=1,
                       early_stop=EarlyStopMonitor(FIT_PATIENCE,
                                                   save_dir=ckpt_dir))
        runs[dev] = (hist, steps, ckpt_dir)
    launches = dict(attention.launch_counts)
    (hg, sg, ckpt_dir), (hc, sc, _) = runs["cuda"], runs["cpu"]
    resumed = pkg.Engine(_tiny(pkg), pkg.parse_config_dict(MEMORY_RAW))
    resumed.load_checkpoint(os.path.join(ckpt_dir, "ckpt_epoch0001.pt"))
    hr = resumed.fit(epochs=1, log=lambda line: None, val_snapshot=True)

    def rel(a, b):
        return abs(a - b) / abs(b)

    res = dict(phase="fit_reference", steps=len(sg),
               max_step_loss_diff=max(abs(a - b) for a, b in zip(sg, sc)),
               loss_gpu=hg["loss"], loss_cpu=hc["loss"],
               max_loss_rel_diff=max(map(rel, hg["loss"], hc["loss"])),
               val_gpu=hg["val"], val_cpu=hc["val"],
               max_val_diff=max(abs(a - b) for a, b in zip(hg["val"],
                                                          hc["val"])),
               resumed_epoch=resumed._epoch, resumed_loss=hr["loss"],
               resumed_val=hr["val"],
               resumed_loss_rel_diff=rel(hr["loss"][0], hg["loss"][1]),
               resumed_val_diff=abs(hr["val"][0] - hg["val"][1]),
               loss_tol=LOSS_TOL, mrr_tol=MRR_TOL, launches_gpu=launches)
    emit(res)
    ok = (len(sg) == len(sc) == FIT_EPOCHS * 6
          and res["max_step_loss_diff"] <= LOSS_TOL
          and res["max_loss_rel_diff"] <= LOSS_TOL
          and res["max_val_diff"] <= MRR_TOL and resumed._epoch == 2
          and res["resumed_loss_rel_diff"] == 0.0
          and res["resumed_val_diff"] == 0.0
          and launches["attention_fwd"] > 0 and launches["attention_bwd"] > 0)
    if not ok:
        raise AssertionError("fit_reference: GPU and CPU fits, or the "
                             "resumed fit, disagree")


def _metrics_events(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_fit(torch, root, tmp):
    """The port's CLI (``run_tgn.main``) at full width: TGN-memory.yml on
    the tgbl-wiki-shaped synthetic stream, 2 epochs with a checkpoint an
    epoch, patience 5, the val snapshot, the test pass and the profiled
    first epoch; then resumed from its epoch-1 checkpoint into a second
    log directory (1 epoch), the same again into a third (two resumed
    runs, the card's run-to-run spread), and from its epoch-2 checkpoint
    with
    ``--epochs 2 --run-test`` (no epoch, only the test pass).  Each run's
    launches are counted from 0, with every eval pass's embed chunks.
    Returns the first run's launches and expected launches."""
    from tgb_tgn_dgl_tpu_torch.engine.train import Engine
    from tgb_tgn_dgl_tpu_torch.ops import attention
    from tgb_tgn_dgl_tpu_torch.run_tgn import main
    from tgb_tgn_dgl_tpu_torch.utils.metrics import TRACE_FILE
    cfg = os.path.join(root, "tgb_tgn_dgl_tpu_torch", "configs",
                       "TGN-memory.yml")
    d1, d2, d3 = (os.path.join(tmp, f"fit_run{i}") for i in (1, 2, 3))
    base = ["--data", "tgbl-wiki", "--synthetic", "--config", cfg,
            "--epochs", str(FIT_EPOCHS), "--checkpoint-every", "1",
            "--patience", str(FIT_PATIENCE), "--val-snapshot"]
    test_only = base[:5] + ["--epochs", str(FIT_EPOCHS), "--resume",
                            os.path.join(d1, "ckpt_epoch0002.pt"),
                            "--run-test"]
    evaluate = Engine.evaluate
    passes = []

    def recorded(self, split="val"):
        out = evaluate(self, split)
        passes.append(dict(split=split, **_eval_record(self.last_eval_trace)))
        return out

    runs = {}
    Engine.evaluate = recorded
    try:
        for name, argv in (
                ("first", base + ["--log-dir", d1, "--run-test",
                                  "--profile"]),
                ("resumed", base + ["--log-dir", d2, "--resume",
                                    os.path.join(d1, "ckpt_epoch0001.pt")]),
                ("resumed_again", base + ["--log-dir", d3, "--resume",
                                          os.path.join(d1,
                                                       "ckpt_epoch0001.pt")]),
                ("test_only", test_only)):
            del passes[:]
            reset_counts(attention)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = main(argv)
            torch.cuda.synchronize()
            trained = sum(len(h["loss"]) for h in out["histories"])
            steps = out["engine"].last_epoch_trace.get("batches", 0)
            runs[name] = dict(
                seconds=time.perf_counter() - t0, epochs_trained=trained,
                epoch=out["engine"]._epoch, test=out["test"],
                load_s=out["load_s"],
                launches=counts_now(attention),
                expected=dict(attention_fwd=0, attention_bwd=0,
                              attention_fwd_drop=steps * trained,
                              attention_fwd_infer=sum(
                                  p["embed_chunks"] for p in passes),
                              attention_bwd_drop=steps * trained,
                              gather_bwd=2 * steps * trained),
                steps_per_epoch=steps, eval_passes=list(passes))
            del out
    finally:
        Engine.evaluate = evaluate
    first, resumed, test_only = (runs[k] for k in ("first", "resumed",
                                                   "test_only"))
    ev1, ev2 = _metrics_events(d1), _metrics_events(d2)
    epochs = [dict(epoch=e["epoch"], train_s=e["seconds"],
                   edges_per_s=e["events_per_s"], loss=e["loss"])
              for e in ev1 if e["event"] == "train_epoch"]
    vals = [dict(epoch=e["epoch"], mrr=e["value"], seconds=e["seconds"])
            for e in ev1 if e["event"] == "val"]
    ckpts = [dict(epoch=e["epoch"], bytes=e["bytes"], save_s=e["seconds"])
             for e in ev1 if e["event"] == "checkpoint"]
    loss2 = [e["loss"] for e in ev2 if e["event"] == "train_epoch"]
    val2 = [e["value"] for e in ev2 if e["event"] == "val"]
    ev3 = _metrics_events(d3)
    loss3 = [e["loss"] for e in ev3 if e["event"] == "train_epoch"]
    val3 = [e["value"] for e in ev3 if e["event"] == "val"]
    trace = os.path.join(d1, "profile", TRACE_FILE)
    with open(trace) as f:
        text = f.read()
    names = {k: k in text for k in ("attention_fwd_kernel",
                                    "attention_bwd_kernel",
                                    "gather_rows_bwd_kernel")}
    res = dict(phase="fit", config="TGN-memory.yml", epochs=epochs,
               val=vals, checkpoints=ckpts,
               load_s=[resumed["load_s"], test_only["load_s"]],
               test_mrr=first["test"], trace_bytes=os.path.getsize(trace),
               trace_names_kernels=names,
               resumed=dict(epoch=resumed["epoch"], loss=loss2, val=val2),
               resumed_loss_rel_diff=abs(loss2[0] - epochs[1]["loss"])
               / abs(epochs[1]["loss"]) if loss2 else None,
               resumed_val_diff=abs(val2[0] - vals[1]["mrr"])
               if val2 else None,
               # the same resume twice: the card's run-to-run spread
               resumed_again=dict(loss=loss3, val=val3),
               resume_spread_loss_rel=abs(loss3[0] - loss2[0])
               / abs(loss2[0]) if loss2 and loss3 else None,
               resume_spread_val=abs(val3[0] - val2[0])
               if val2 and val3 else None,
               test_only=dict(epochs_trained=test_only["epochs_trained"],
                              test_mrr=test_only["test"],
                              test_diff=abs(test_only["test"]
                                            - first["test"]),
                              tol=RESUME_TEST_TOL),
               metrics_events={k: sum(e["event"] == k for e in ev1)
                               for k in ("train_epoch", "val",
                                         "checkpoint")},
               **{f"{k}_run": {f: runs[k][f] for f in (
                   "seconds", "epochs_trained", "steps_per_epoch",
                   "launches", "expected", "eval_passes")}
                  for k in runs})
    emit(res)
    bad = []
    if not (len(epochs) == FIT_EPOCHS and len(vals) == FIT_EPOCHS):
        bad.append(f"metrics.jsonl events {res['metrics_events']}")
    if len(ckpts) != FIT_EPOCHS or not all(names.values()):
        bad.append(f"checkpoints {ckpts}, kernels named in trace {names}")
    if not (resumed["epoch"] == FIT_EPOCHS and len(loss2) == 1
            and res["resumed_loss_rel_diff"] == 0.0
            and res["resumed_val_diff"] == 0.0
            and res["resume_spread_loss_rel"] == 0.0
            and res["resume_spread_val"] == 0.0):
        # no atomics in the train step and the padded shapes kept in the
        # checkpoint: a resumed epoch is bit-equal on the card
        bad.append("the resumed epoch 2 differs from the uninterrupted "
                   "one, or two resumed runs differ")
    if test_only["epochs_trained"] != 0 or \
            res["test_only"]["test_diff"] > RESUME_TEST_TOL:
        bad.append("the resume-only run trained or tested otherwise")
    if not 0.0 < first["test"] <= 1.0:
        bad.append(f"test MRR {first['test']}")
    for k, r in runs.items():
        if r["launches"] != r["expected"] or (
                r["epochs_trained"] and r["steps_per_epoch"]
                != WIKI_TRAIN_STEPS):
            bad.append(f"{k} run launches {r['launches']}, expected "
                       f"{r['expected']}")
    if bad:
        raise AssertionError("fit: " + "; ".join(bad))
    return first["launches"], first["expected"]


# --------------------------------------------- device-side stream state
# DevicePack fields of a lean expansion that must equal the host pack (the
# lean read set, uniq_nid / root_loc / nbr_loc, repeats nodes by design)
LEAN_COMPARE = ("ev_src", "ev_dst", "ev_t", "ev_idx", "ev_valid", "ev_neg",
                "root_nid", "root_valid", "nbr_nid", "nbr_dt", "nbr_kind",
                "nbr_feat", "ev_src_slot", "ev_pos_slot", "ev_neg_slot",
                "mw_node", "mw_slot", "mw_partner", "mw_t", "mw_eid")
LEAN_VAL_BATCHES = 2


def _split_batches(data, cfg, split, sampler=None, fixed=None):
    """(rows, blocks, negatives) of each batch of ``split`` at the
    config's batch size: one sampled negative an event (``sampler``) or
    the fixed negatives (``fixed``); and the split's blocks."""
    from tgb_tgn_dgl_tpu_torch.data.dependency import dependency_aware_batch
    B = cfg.train.batch_size
    rows = getattr(data, f"{split}_mask").nonzero()[0]
    blocks = dependency_aware_batch(data.src[rows], data.dst[rows], B)
    out = []
    for lo in range(0, len(rows), B):
        r, blk = rows[lo:lo + B], blocks[lo:lo + B]
        neg = (sampler.sample(data.dst[r]) if fixed is None
               else fixed.query_batch(lo, lo + len(r))[0])
        out.append((r, blk, neg))
    return out, blocks


def _packer_config(cfg):
    from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig
    return PackerConfig(num_neighbors=cfg.sampling.num_neighbors,
                        batch_size=cfg.train.batch_size,
                        max_intra_block=cfg.train.max_intra_block,
                        mailbox_size=cfg.memory.mailbox_size)


def phase_lean_wire(torch, data, cfg_path):
    """Device-cache mode's wire at full width (the packer settings of
    ``cfg_path``, TGN-memory.yml: K=10, batch 2000, max_intra_block 32,
    mailbox 1) on the tgbl-wiki-shaped stream: the lean packer, the host
    packer (``pack``, the plain version) and the dedup packer in lockstep
    over the whole train split and every negative chunk of the first
    LEAN_VAL_BATCHES val batches.  Each lean wire crosses to the card and
    ``expand_lean`` rebuilds the DevicePack there from the resident
    state: equal to to_device of the host pack in LEAN_COMPARE's fields,
    dtypes included; after each batch (at eval, its last chunk)
    ``advance_stream``'s state must equal the host packer's snapshot
    exactly: cache neighbors, event ids, times and clocks; so must the
    epoch-start reset.  Reports the lean wire's bytes per train batch and
    per eval chunk beside the dedup wire's (eval chunks eval-lean, as the
    engine ships them), and the host ms of both packs."""
    import numpy as np
    from tgb_tgn_dgl_tpu_torch.data.lean_packer import NativeLeanPacker
    from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
    from tgb_tgn_dgl_tpu_torch.data.packer import to_device
    from tgb_tgn_dgl_tpu_torch.engine.negatives import (FixedNegatives,
                                                        NegLinkSamplerDest)
    from tgb_tgn_dgl_tpu_torch.engine.train import eval_neg_chunk_size
    from tgb_tgn_dgl_tpu_torch.ops.lean_wire import (advance_stream,
                                                     expand_lean,
                                                     init_stream_device_state,
                                                     reset_stream_cache)
    from tgb_tgn_dgl_tpu_torch.ops.wire import (eval_lean_dedup,
                                                nb_bucket_of, wire_nbytes,
                                                wire_to_device)
    from tgb_tgn_dgl_tpu_torch.utils.config import parse_config
    cfg = parse_config(cfg_path)
    B, K, N = cfg.train.batch_size, cfg.sampling.num_neighbors, data.num_nodes
    pk = _packer_config(cfg)
    host, dedup = NativeStreamPacker(N, pk), NativeStreamPacker(N, pk)
    lean = NativeLeanPacker(N, pk)
    st = init_stream_device_state(N, K, "cuda")
    rec = {f"{w}_{k}_{u}": [] for w in ("lean", "dedup")
           for k in ("train", "chunk") for u in ("bytes", "ms")}
    bad = []

    def state_differs():
        nbr, eid, t, clock = host.snapshot()[:4]
        return [name for name, a, b in (
            ("cache_nbr", st.cache.neighbors, nbr),
            ("cache_eid", st.cache.e_id, eid.astype(np.int32)),
            ("cache_t", st.cache.t, t), ("clock", st.clock, clock))
            if not np.array_equal(a[:-1].cpu().numpy(), b)]

    def step(what, args, kw, last, post=None):
        nonlocal st
        em = kw.get("eval_mode", False)
        kind = "chunk" if em else "train"
        t0 = time.perf_counter()
        lw, iw = lean.pack_wire(*args, **kw)
        t1 = time.perf_counter()
        dw, _ = dedup.pack_wire_dedup(*args, **kw)
        t2 = time.perf_counter()
        if post is not None:
            dw = post(dw)
        want = to_device(host.pack(*args, **kw), "cuda")
        dev = wire_to_device(lw, "cuda")
        got, _ = expand_lean(dev, st, K, iw, N, eval_mode=em, batch_size=B)
        differ = [f for f in LEAN_COMPARE
                  if getattr(got, f).dtype != getattr(want, f).dtype
                  or not torch.equal(getattr(got, f), getattr(want, f))]
        if last:
            st = advance_stream(st, dev, N, eval_mode=em)
            differ += state_differs()
        if differ:
            bad.append((what, differ))
        rec[f"lean_{kind}_bytes"].append(wire_nbytes(lw))
        rec[f"dedup_{kind}_bytes"].append(wire_nbytes(dw))
        rec[f"lean_{kind}_ms"].append((t1 - t0) * 1e3)
        rec[f"dedup_{kind}_ms"].append((t2 - t1) * 1e3)

    train, _ = _split_batches(data, cfg, "train", NegLinkSamplerDest(
        data.unique_dst(), seed=cfg.train.seed))
    for bi, (r, blk, neg) in enumerate(train):
        step(f"train batch {bi}",
             (data.src[r], data.dst[r], data.t[r], r, blk, neg), {}, True)
    val, vblocks = _split_batches(data, cfg, "val",
                                  fixed=FixedNegatives(data.val_ns))
    nbb = nb_bucket_of(vblocks)
    chunks = 0
    for bi, (r, blk, neg) in enumerate(val[:LEAN_VAL_BATCHES]):
        Mc = eval_neg_chunk_size(cfg, neg.shape[1], len(r))
        n_chunks = -(-neg.shape[1] // Mc)
        for ci in range(n_chunks):
            last = ci == n_chunks - 1
            step(f"val batch {bi} chunk {ci}",
                 (data.src[r], data.dst[r], data.t[r], r, blk,
                  neg[:, ci * Mc:(ci + 1) * Mc]),
                 dict(eval_mode=True, insert=last, write_mail=last), last,
                 post=lambda w, blk=blk: eval_lean_dedup(w, blk, nbb))
            chunks += 1
    host.reset_cache()
    st = reset_stream_cache(st)
    reset_differs = state_differs()
    med = {k: statistics.median(v) for k, v in rec.items()}
    emit(dict(phase="lean_wire", train_batches=len(train),
              eval_chunks=chunks,
              val_batches=len(val[:LEAN_VAL_BATCHES]),
              fields_differ=bad[:5], reset_differs=reset_differs,
              median=med,
              lean_over_dedup_bytes={
                  k: med[f"lean_{k}_bytes"] / med[f"dedup_{k}_bytes"]
                  for k in ("train", "chunk")},
              lean_over_dedup_ms={
                  k: med[f"lean_{k}_ms"] / med[f"dedup_{k}_ms"]
                  for k in ("train", "chunk")},
              max_bytes={k: max(v) for k, v in rec.items()
                         if k.endswith("bytes")},
              sstate_bytes=sum(t.numel() * t.element_size()
                               for t in (*st.cache, st.clock)),
              host_ms_is="the chip machine's CPU, this call"))
    if bad or reset_differs:
        raise AssertionError(f"lean expansion or device state differs from "
                             f"the host packer: {bad[:5]} {reset_differs}")


def phase_train_lean_wire(torch, data, cfg_path):
    """The train-lean wire at full width on the same stream: over the whole
    train split, each dedup wire and its ``train_lean_dedup`` (the clocks
    read from the packer before the batch) cross to the card and expand
    there; the train-lean expansion must equal the full-Δt one exactly.
    Bytes of both wires and the post-pass's host ms."""
    from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
    from tgb_tgn_dgl_tpu_torch.engine.negatives import NegLinkSamplerDest
    from tgb_tgn_dgl_tpu_torch.ops.wire import (expand_any, nb_bucket_of,
                                                train_lean_dedup,
                                                wire_nbytes, wire_to_device)
    from tgb_tgn_dgl_tpu_torch.utils.config import parse_config
    cfg = parse_config(cfg_path)
    K, N = cfg.sampling.num_neighbors, data.num_nodes
    packer = NativeStreamPacker(N, _packer_config(cfg))
    times = torch.from_numpy(data.t.astype("float32")).cuda()
    train, blocks = _split_batches(data, cfg, "train", NegLinkSamplerDest(
        data.unique_dst(), seed=cfg.train.seed))
    nbb = nb_bucket_of(blocks)
    rec = {"full_bytes": [], "lean_bytes": [], "post_ms": []}
    bad, not_lean = [], []
    for bi, (r, blk, neg) in enumerate(train):
        clock = packer.clock_snapshot()
        w, iw = packer.pack_wire_dedup(data.src[r], data.dst[r], data.t[r],
                                       r, blk, neg)
        t0 = time.perf_counter()
        lw = train_lean_dedup(w, blk, nbb, clock)
        rec["post_ms"].append((time.perf_counter() - t0) * 1e3)
        if lw.clock0 is None:
            not_lean.append(bi)
        full = expand_any(wire_to_device(w, "cuda"), K, iw, N)
        got = expand_any(wire_to_device(lw, "cuda"), K, iw, N, times)
        differ = _fields_differ(torch, got, full)
        if differ:
            bad.append((bi, differ))
        rec["full_bytes"].append(wire_nbytes(w))
        rec["lean_bytes"].append(wire_nbytes(lw))
    med = {k: statistics.median(v) for k, v in rec.items()}
    emit(dict(phase="train_lean_wire", train_batches=len(train),
              nb_bucket=nbb, fields_differ=bad[:5], not_lean=not_lean,
              median=med,
              lean_over_full_bytes=med["lean_bytes"] / med["full_bytes"],
              host_ms_is="the chip machine's CPU, this call"))
    if bad or not_lean:
        raise AssertionError(f"train-lean expansion differs from the full "
                             f"wire's: {bad[:5]}, not lean: {not_lean}")


def _with_train(raw, **train):
    return dict(raw, train=[dict(raw["train"][0], **train)])


def _tiny_run(pkg, raw, dev):
    """One train epoch and the val pass of the tiny stream on ``dev``:
    (per-step losses, epoch stats, val MRR, engine)."""
    eng, losses = _recording_engine(pkg, raw, dev)
    stats = eng.train_epoch()
    return losses, stats, eng.evaluate("val"), eng


def _sstate_equal(torch, a, b):
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip((*a.cache, a.clock), (*b.cache, b.clock)))


def _against_other_arm(torch, phase, arm, got, want):
    """Two tiny GPU runs of the same weights, one per transport: the
    largest per-step loss difference, the epoch losses, the val MRRs and,
    with the memory, the memory states; within the reference phases'
    tolerances."""
    (lg, sg, mg, eg), (lw, sw, mw, ew) = got, want
    res = dict(max_loss_diff=max(abs(a - b) for a, b in zip(lg, lw)),
               epoch_loss=sg["loss"], epoch_loss_other=sw["loss"],
               mrr=mg, mrr_other=mw, mrr_diff=abs(mg - mw))
    ok = (len(lg) == len(lw) == 6 and res["max_loss_diff"] <= LOSS_TOL
          and res["mrr_diff"] <= MRR_TOL)
    if eg.use_memory:
        diff, same = _state_diff(torch, eg.mem_state, ew.mem_state)
        res.update(diff)
        ok = ok and same
    if not ok:
        raise AssertionError(f"{phase}: {arm} disagrees with the other "
                             f"transport: {res}")
    return res


def phase_device_cache_reference(torch, pkg):
    """Device-cache mode on the tiny stream at dropout 0 (so attention_fwd
    and attention_bwd run), frozen and with the memory: the GPU engine
    against the CPU engine at the memory_reference tolerances (the device
    state exactly), and against the host-pack GPU engine (losses, val MRR,
    memory state; the largest differences printed).  Then, with the
    memory, a GPU run resumed from its epoch-1 checkpoint gives the
    uninterrupted run's epoch 2 exactly (loss, val MRR, device state,
    memory), and ``snapshot_stream``/``restore_stream`` around a val pass
    give the device clocks back bit-equal.  Returns the GPU runs'
    launches."""
    from tgb_tgn_dgl_tpu_torch.ops import attention
    attention.reset_launch_counts()
    for name, raw in (("frozen", REFERENCE_RAW), ("memory", MEMORY_RAW)):
        dc = _with_train(raw, device_cache=True)
        out = _gpu_and_cpu(pkg, dc, protocol="column_chunk")
        res, ok = _compare_runs("device_cache_reference", out)
        eg, ec = out["cuda"][2], out["cpu"][2]
        res.update(path=name, device_cache=eg.device_cache,
                   sstate_gpu_equals_cpu=_sstate_equal(torch, eg.sstate,
                                                       ec.sstate))
        ok = ok and eg.device_cache and res["sstate_gpu_equals_cpu"]
        if eg.use_memory:
            diff, same = _state_diff(torch, eg.mem_state, ec.mem_state)
            res.update(diff)
            ok = ok and same
        res["vs_host_pack_gpu"] = _against_other_arm(
            torch, "device_cache_reference", name,
            _tiny_run(pkg, dc, "cuda"), _tiny_run(pkg, raw, "cuda"))
        emit(res)
        if not ok:
            raise AssertionError(f"device_cache_reference {name}: GPU and "
                                 f"CPU engines disagree")
    raw = _with_train(MEMORY_RAW, device_cache=True)
    whole = pkg.Engine(_tiny(pkg), pkg.parse_config_dict(raw))
    resumed = pkg.Engine(_tiny(pkg), pkg.parse_config_dict(raw))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dc_") as ckpt:
        hw = whole.fit(epochs=FIT_EPOCHS, log=lambda line: None,
                       val_snapshot=True, checkpoint_dir=ckpt,
                       checkpoint_every=1)
        resumed.load_checkpoint(os.path.join(ckpt, "ckpt_epoch0001.pt"))
    hr = resumed.fit(epochs=1, log=lambda line: None, val_snapshot=True)
    mem_equal = all(torch.equal(a, b) for a, b in zip(resumed.mem_state,
                                                      whole.mem_state))
    clock0 = whole.sstate.clock.clone()
    snap = whole.snapshot_stream()
    whole.evaluate("val")
    moved = not torch.equal(whole.sstate.clock, clock0)
    whole.restore_stream(snap)
    res = dict(phase="device_cache_reference", path="resume",
               loss=hw["loss"], val=hw["val"], resumed_loss=hr["loss"],
               resumed_val=hr["val"],
               resumed_loss_diff=abs(hr["loss"][0] - hw["loss"][1]),
               resumed_val_diff=abs(hr["val"][0] - hw["val"][1]),
               resumed_sstate_equal=_sstate_equal(torch, resumed.sstate,
                                                  whole.sstate),
               resumed_mem_state_equal=mem_equal,
               val_pass_moves_clocks=moved,
               snapshot_restores_clocks=torch.equal(whole.sstate.clock,
                                                    clock0))
    launches = dict(attention.launch_counts)
    res["launches_gpu"] = launches
    emit(res)
    if not (res["resumed_loss_diff"] == 0.0 and res["resumed_val_diff"] == 0.0
            and res["resumed_sstate_equal"] and mem_equal and moved
            and res["snapshot_restores_clocks"]
            and launches["attention_fwd"] > 0
            and launches["attention_bwd"] > 0):
        raise AssertionError("device_cache_reference: the resumed run or "
                             "the val snapshot differs")
    return launches


def phase_train_lean_reference(torch, pkg):
    """The train-lean wire on the tiny stream at dropout 0, frozen and with
    the memory: GPU against CPU at the memory_reference tolerances (val by
    the default slot-unique protocol), every train wire train-lean; and
    against the full-Δt wire on the GPU (losses, val MRR, memory
    state)."""
    for name, raw in (("frozen", REFERENCE_RAW), ("memory", MEMORY_RAW)):
        tl = _with_train(raw, wire_train_lean=True)
        out = _gpu_and_cpu(pkg, tl)
        res, ok = _compare_runs("train_lean_reference", out)
        eg, ec = out["cuda"][2], out["cpu"][2]
        res.update(path=name, train_lean=eg.train_lean)
        ok = ok and eg.train_lean
        if eg.use_memory:
            diff, same = _state_diff(torch, eg.mem_state, ec.mem_state)
            res.update(diff)
            ok = ok and same
        res["vs_full_wire_gpu"] = _against_other_arm(
            torch, "train_lean_reference", name,
            _tiny_run(pkg, tl, "cuda"), _tiny_run(pkg, raw, "cuda"))
        emit(res)
        if not ok:
            raise AssertionError(f"train_lean_reference {name}: GPU and "
                                 f"CPU engines disagree")


def _wire_bytes_spy(eng, out):
    """Record the host bytes of every wire ``eng`` packs."""
    from tgb_tgn_dgl_tpu_torch.ops.wire import wire_nbytes
    packed = eng._packed

    def spy(jobs, *args):
        for meta, (wire, iw) in packed(jobs, *args):
            out.append(wire_nbytes(wire))
            yield meta, (wire, iw)

    eng._packed = spy


def phase_transport_train(torch, pkg, data, cfg_path, phase, host,
                          **train):
    """One full train split of ``cfg_path`` at full width with the
    ``train`` knobs (``device_cache`` or ``wire_train_lean``), timed as
    ``train``/``memory_train`` are, beside ``host``, the host-pack arm's
    record from the same call; the knob must have taken effect."""
    import dataclasses
    import math
    cfg = pkg.parse_config(cfg_path)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, sanity_batches=0, **train))
    torch.cuda.reset_peak_memory_stats()
    eng = pkg.Engine(data, cfg)
    if not (eng.device_cache or eng.train_lean):
        raise AssertionError(f"{phase}: {train} did not take effect")
    nbytes = []
    _wire_bytes_spy(eng, nbytes)
    rec = _timed_first_step(torch, eng)
    torch.cuda.synchronize()
    rec["start"].record()
    stats = eng.train_epoch()
    torch.cuda.synchronize()
    tr = eng.last_epoch_trace
    times = _train_times(stats, tr, rec, cfg.train.batch_size)
    emit(dict(phase=phase, config=os.path.basename(cfg_path), **train,
              events=stats["events"], steps=tr["batches"],
              loss_sum=stats["loss"], ap=stats["ap"], auc=stats["auc"],
              **times, wire_bytes_median=statistics.median(nbytes),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
              host_pack={k: host[k] for k in (
                  "loss_sum", "seconds", "edges_per_s",
                  "after_first_step_edges_per_s", "first_step_s", "pack_s",
                  "fetch_s", "copy_s", "disp_s", "peak_mem_gb")},
              edges_per_s_over_host=times["edges_per_s"]
              / host["edges_per_s"]))
    if not math.isfinite(stats["loss"]):
        raise AssertionError(f"{phase}: non-finite training loss")
    return eng


def phase_device_cache_eval(torch, eng, phase, host_unique, host_chunked):
    """The device-cache engine's val pass with every negative, by the
    column-chunk protocol (the gate closes with "device_cache mode"),
    beside the host-pack arm's slot-unique and column-chunk passes from
    the same call; MRR in (0, 1] and its difference from the host arm's.
    Returns its record."""
    mrr, seconds, rec, peak = _val_pass(torch, eng)
    res = dict(phase=phase, mrr=mrr, seconds=seconds, **rec,
               peak_mem_gb=peak,
               gate_closed_by=sorted(eng._eval_gate_logged),
               host_pack_mrr=host_unique["mrr"],
               mrr_diff_from_host=mrr - host_unique["mrr"],
               host_pack_seconds_slot_unique=host_unique["seconds"],
               host_pack_seconds_column_chunk=host_chunked[
                   "seconds_column_chunk"],
               host_pack_column_chunk={k: host_chunked["column_chunk"][k]
                                       for k in ("pack_s", "fetch_s",
                                                 "copy_s", "disp_s")})
    emit(res)
    if not 0.0 < mrr <= 1.0:
        raise AssertionError(f"{phase}: val MRR {mrr} outside (0, 1]")
    if rec["protocol"] != "column_chunk" or res["gate_closed_by"] != [
            "device_cache mode"]:
        raise AssertionError(f"{phase}: took {rec['protocol']}, the gate "
                             f"closed by {res['gate_closed_by']}")
    return res


def phase_device_cache_large_n(torch, pkg, cfg_path):
    """configs/TGN.yml on a stream of tgbl-review's 352,637 nodes cut to
    LOW_DEDUP_EDGES events: one train epoch on the host packer and one in
    device-cache mode, from the same seed.  Seconds, pack_s, fetch_s,
    copy_s, disp_s, wire bytes a batch, the device state's bytes and the
    loss of each."""
    import dataclasses
    import math
    data = pkg.synthetic("tgbl-review", num_edges=LOW_DEDUP_EDGES)
    arms = {}
    for arm, dc in (("host_pack", False), ("device_cache", True)):
        cfg = pkg.parse_config(cfg_path)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, device_cache=dc))
        torch.cuda.reset_peak_memory_stats()
        eng = pkg.Engine(data, cfg)
        nbytes = []
        _wire_bytes_spy(eng, nbytes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = eng.train_epoch()
        torch.cuda.synchronize()
        tr = eng.last_epoch_trace
        arms[arm] = dict(
            seconds=time.perf_counter() - t0, loss_sum=stats["loss"],
            events=stats["events"], steps=tr["batches"],
            **{k: tr[k] for k in ("pack_s", "fetch_s", "copy_s", "disp_s")},
            wire_bytes_median=statistics.median(nbytes),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            sstate_bytes=(sum(t.numel() * t.element_size()
                              for t in (*eng.sstate.cache, eng.sstate.clock))
                          if dc else None))
        del eng
    emit(dict(phase="device_cache_large_n", nodes=data.num_nodes,
              events=LOW_DEDUP_EDGES, **arms,
              seconds_ratio=arms["device_cache"]["seconds"]
              / arms["host_pack"]["seconds"]))
    if not all(math.isfinite(a["loss_sum"]) for a in arms.values()):
        raise AssertionError("device_cache_large_n: non-finite loss")


def _profiled(torch, fn):
    """Run ``fn`` under torch.profiler; return (wall seconds, kernel
    seconds, host-to-device copy seconds, kernel launches, top kernels).
    Only the trace's device-side entries count (the aten ops that launched
    them carry the same time again); the sums are None when the trace
    holds no device entry."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    if not rows:
        return wall, None, None, None, []
    copies = sum(t for k, t, _ in rows if k.startswith("Memcpy")) / 1e6
    kernels = [r for r in rows if not r[0].startswith(("Memcpy", "Memset"))]
    busy = sum(t for _, t, _ in kernels) / 1e6
    top = [dict(name=k[:90], device_ms=t / 1e3, calls=n)
           for k, t, n in sorted(kernels, key=lambda r: -r[1])[:15]]
    return wall, busy, copies, sum(n for _, _, n in kernels), top


def _sync_sites(torch, fn):
    """Run ``fn`` with torch.cuda's sync debug mode warning; return the
    file:line of each operation that waited for the device."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def phase_profile(torch, pkg, data, cfg_path, path, protocol="slot_unique",
                  evals=True, **train):
    """Where the time goes: a traced run of 4 train steps and (with
    ``evals``) of the first val batch on a fresh engine of ``path``
    (frozen, memory, layer2, jodie, dyrep, or device_cache and train_lean
    with their ``train`` knobs), by the default protocol, which must be
    ``protocol``, and, where that is slot-unique, then by the column-chunk
    protocol (all its negative chunks).  The kernel busy share is the
    summed kernel time over the wall time; one minus it is the device's
    idle share (copies run on their own engine).  A run that waits for the
    device more than once (its one metrics fetch) fails: the host would
    stall on the device there."""
    import dataclasses
    cfg = pkg.parse_config(cfg_path)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, sanity_batches=4, **train))
    val_rows = data.val_mask.nonzero()[0]
    cut = data.val_mask.copy()
    cut[val_rows[cfg.train.batch_size:]] = False
    eng = pkg.Engine(dataclasses.replace(data, val_mask=cut), cfg)
    eng.train_epoch()                              # warm-up, untraced

    runs = [("train_4_steps", eng.train_epoch)]
    if evals:
        runs.append(("eval_first_val_batch", lambda: eng.evaluate("val")))
    if evals and protocol == "slot_unique":
        runs.append(("eval_first_val_batch_column_chunk",
                     lambda: eng._evaluate_chunked("val")))
    for what, fn in runs:
        wall, busy, copies, launches, top = _profiled(torch, fn)
        trace = (eng.last_epoch_trace if what.startswith("train")
                 else eng.last_eval_trace)
        syncs = _sync_sites(torch, fn)
        extra = ({} if what.startswith("train") else
                 {k: trace[k] for k in ("protocol", "embed_chunks",
                                        "score_chunks")})
        emit(dict(phase="profile", path=path, run=what, wall_s=wall,
                  host_pack_s=trace["pack_s"],
                  host_fetch_s=trace["fetch_s"],
                  host_copy_s=trace["copy_s"], host_disp_s=trace["disp_s"],
                  kernel_busy_s=busy, kernel_launches=launches,
                  h2d_copy_s=copies,
                  kernel_busy_share=None if busy is None else busy / wall,
                  syncs=len(syncs), sync_sites=sorted(set(syncs)),
                  **extra, top_kernels=top))
        if len(syncs) > 1:
            raise AssertionError(f"{path} {what} waited for the device "
                                 f"{len(syncs)} times: {sorted(set(syncs))}")
        if what == "eval_first_val_batch" and trace["protocol"] != protocol:
            raise AssertionError(f"{path} {what} took {trace['protocol']}")


# --------------------------------------------------- multi-host super-batches
MH_TAIL_STEPS = 2              # the tiny stream's 599 train events at 2 x 100


def _recording_mh_engine(pkg, raw, dev, exchange):
    """A MultiHostEngine of ``raw`` at 2 hosts on the tiny stream, and the
    list its composed steps and tail steps append their losses to."""
    eng = pkg.MultiHostEngine(_tiny(pkg), pkg.parse_config_dict(raw),
                              n_hosts=2, exchange=exchange, device=dev)
    losses = []
    composed, step = eng._composed_step, eng._train_step

    def rec_composed(*args):
        out = composed(*args)
        losses.append(float(out[-3]))           # (…, loss, pos, neg)
        return out

    def rec(pack, acc):
        loss, acc = step(pack, acc)
        losses.append(float(loss))
        return loss, acc

    eng._composed_step, eng._train_step = rec_composed, rec
    return eng, losses


def _params_diff(torch, got, want):
    """The largest |a - b| - TOL·|b| over two models' parameters (<= 0
    within LOSS_TOL abs+rel) and the largest |a - b|."""
    over = err = 0.0
    for a, b in zip(got.model.parameters(), want.model.parameters()):
        d = (a.detach().cpu() - b.detach().cpu()).abs()
        err = max(err, float(d.max()))
        over = max(over, float((d - LOSS_TOL * b.detach().cpu().abs()).max()))
    return over, err


def _packers_equal(a, b):
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(a.packer.snapshot(),
                                                    b.packer.snapshot()))


def _bit_equal(torch, a, b):
    """Two engines' parameters, memory state and packer state, bit for
    bit."""
    same = all(torch.equal(x, y) for x, y in zip(a.model.parameters(),
                                                b.model.parameters()))
    if a.use_memory:
        same = same and all(torch.equal(x, y)
                            for x, y in zip(a.mem_state, b.mem_state))
    return same and _packers_equal(a, b)


def phase_multihost_reference(torch, pkg, attention):
    """MultiHostEngine at 2 hosts on the tiny stream at dropout 0 (2
    super-batches and 2 tail batches), GPU against CPU from the same
    weights, for frozen TGN, the memory, JODIE and DyRep: every step's
    loss within LOSS_TOL, the parameters within LOSS_TOL abs+rel, the
    memory state as memory_reference holds it, the packer state exactly;
    the owned exchange (memory, DyRep) on the GPU bit-equal to the
    replicated one, both run under torch.use_deterministic_algorithms: at
    this size the memory path's default CUDA ops are not bit-reproducible
    from run to run (a second replicated run in the default mode says
    whether it repeats the first, ``default_rerun_bit_equal``).  The GPU's
    replicated run launches the dropout-0 pair once a step (DyRep: once a
    range of a super-batch and once a tail step), JODIE none."""
    cases = (("frozen", REFERENCE_RAW, False),
             ("memory", MEMORY_RAW, True),
             ("jodie", _arch_raw("identity"), False),
             ("dyrep", _arch_raw("dyrep", use_dst_emb_in_msg=True), True))
    for name, raw, owned in cases:
        runs = {}
        arms = [("cuda", "replicated", False), ("cpu", "replicated", False)]
        if owned:
            arms += [("cuda", "replicated", "rerun"),
                     ("cuda", "replicated", True), ("cuda", "owned", True)]
        for dev, exchange, det in arms:
            attention.reset_launch_counts()
            torch.use_deterministic_algorithms(det is True, warn_only=True)
            try:
                eng, losses = _recording_mh_engine(pkg, raw, dev, exchange)
                stats = eng.train_epoch()
            finally:
                torch.use_deterministic_algorithms(False)
            runs[dev, exchange, det] = (eng, losses, stats,
                                        dict(attention.launch_counts))
        (eg, lg, sg, launches), (ec, lc, sc, _) = (
            runs["cuda", "replicated", False],
            runs["cpu", "replicated", False])
        tr = eg.last_epoch_trace
        over, perr = _params_diff(torch, eg, ec)
        res = dict(phase="multihost_reference", config=name, n_hosts=2,
                   super_batches=tr["super_batches"], steps=len(lg),
                   losses_gpu=lg, losses_cpu=lc,
                   max_loss_diff=max(abs(a - b) for a, b in zip(lg, lc)),
                   epoch_loss_gpu=sg["loss"], epoch_loss_cpu=sc["loss"],
                   max_param_diff=perr, loss_tol=LOSS_TOL,
                   packer_equal=_packers_equal(eg, ec),
                   launches_gpu=launches)
        ok = (len(lg) == len(lc) == tr["super_batches"] + MH_TAIL_STEPS
              and res["max_loss_diff"] <= LOSS_TOL and over <= LOSS_TOL
              and res["packer_equal"])
        if eg.use_memory:
            diff, same = _state_diff(torch, eg.mem_state, ec.mem_state,
                                     MAIL_TE_TOL)
            res.update(diff)
            ok = ok and same
        if owned:
            er, lr, sr, _ = runs["cuda", "replicated", "rerun"]
            ed, ld, sd, _ = runs["cuda", "replicated", True]
            eo, lo, so, _ = runs["cuda", "owned", True]
            res.update(default_rerun_bit_equal=lr == lg and sr == sg
                       and _bit_equal(torch, er, eg),
                       deterministic_losses_gpu=ld, owned_losses_gpu=lo,
                       owned_bit_equal=lo == ld and so == sd
                       and _bit_equal(torch, eo, ed))
            ok = ok and res["owned_bit_equal"]
        steps = (2 * tr["super_batches"] if eg.eager_memory
                 else tr["super_batches"]) + MH_TAIL_STEPS
        want = dict(attention_fwd=steps, attention_bwd=steps,
                    attention_fwd_drop=0, attention_bwd_drop=0,
                    attention_fwd_infer=0)
        if name == "jodie":
            want = {k: 0 for k in want}
        res["launches_expected"] = want
        emit(res)
        if not ok or launches != want:
            raise AssertionError(f"multihost_reference {name}: GPU and CPU "
                                 f"(or the two exchanges) disagree, or "
                                 f"launches {launches} != {want}")


def _mh_train_arm(torch, pkg, attention, data, cfg_path, n_hosts, exchange,
                  evals):
    """One MultiHostEngine epoch at full width (the buckets warmed first,
    timed apart) and, with ``evals``, its slot-unique val pass, the
    launches counted from 0 just before: (record, engine, packer state
    after the epoch, launches)."""
    import math
    cfg = pkg.parse_config(cfg_path)
    B = cfg.train.batch_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(attention)
    eng = pkg.MultiHostEngine(data, cfg, n_hosts=n_hosts, exchange=exchange)
    t0 = time.perf_counter()
    eng.warm_buckets()
    eng._warmed = True
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = eng.train_epoch()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tr = eng.last_epoch_trace
    packer = eng.packer.snapshot()
    rec = dict(exchange=exchange, n_hosts=n_hosts, events=stats["events"],
               loss_sum=stats["loss"], ap=stats["ap"], auc=stats["auc"],
               seconds=seconds, edges_per_s=stats["events"] / seconds,
               warm_s=warm_s, trace=dict(tr),
               tail_batches=-(-(stats["events"] - n_hosts * B
                                * tr["super_batches"]) // B),
               train_peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               width=dict(arch=cfg.gnn.arch, D=cfg.gnn.dim_out,
                          H=cfg.gnn.att_head, K=cfg.sampling.num_neighbors,
                          batch=cfg.train.batch_size,
                          memory=eng.use_memory))
    if not math.isfinite(stats["loss"]):
        raise AssertionError(f"non-finite multi-host loss ({exchange})")
    if evals:
        mrr, vsec, vrec, peak = _val_pass(torch, eng)
        if vrec["protocol"] != "slot_unique" or not 0.0 < mrr <= 1.0:
            raise AssertionError(f"multi-host val pass: {vrec}, MRR {mrr}")
        rec.update(val_mrr=mrr, val_seconds=vsec, val=vrec,
                   val_peak_mem_gb=peak)
    return rec, eng, packer, counts_now(attention)


def _mh_want(rec, launches_per_step=1, embed_chunks=0):
    """The launches a multi-host path must count: the dropout pair once a
    composed step (``launches_per_step`` for DyRep's ranges) and once a
    tail step, the inference forward once an embed chunk of its val
    pass, and with the memory the gather backward twice wherever the
    dropout pair's backward runs once."""
    tr = rec["trace"]
    steps = launches_per_step * tr["super_batches"] + rec["tail_batches"]
    return dict(attention_fwd=0, attention_bwd=0, attention_fwd_drop=steps,
                attention_bwd_drop=steps, attention_fwd_infer=embed_chunks,
                gather_bwd=2 * steps if rec["width"]["memory"] else 0)


def phase_multihost_train(torch, pkg, attention, data, cfg_path, serial_rec,
                          serial_packer):
    """TGN-memory.yml at full width, 2 hosts: one epoch and the
    slot-unique val pass with the replicated and with the owned exchange
    from the same initial weights, beside the serial Engine's epoch of
    this call (``serial_rec``).  The packer state after each epoch must
    equal the serial Engine's (``serial_packer``).  Returns each arm's
    launches and expected launches."""
    import numpy as np
    counts, wants, arms = {}, {}, {}
    for exchange in ("replicated", "owned"):
        rec, eng, packer, launches = _mh_train_arm(
            torch, pkg, attention, data, cfg_path, 2, exchange, True)
        rec["packer_equals_serial"] = [
            name for name, a, b in zip(
                ("cache_nbr", "cache_eid", "cache_t", "clock", "cur_e_id",
                 "mail_ptr"), packer, serial_packer)
            if not np.array_equal(a, b)] == []
        path = f"multihost_memory_{exchange}"
        counts[path] = launches
        wants[path] = _mh_want(rec, 1, rec["val"]["embed_chunks"])
        arms[exchange] = rec
        del eng
    rep, own = arms["replicated"], arms["owned"]
    emit(dict(phase="multihost_train", config="TGN-memory.yml",
              serial_edges_per_s=serial_rec["edges_per_s"],
              serial_seconds=serial_rec["seconds"], replicated=rep,
              owned=own, owned_loss_equal=own["loss_sum"] == rep["loss_sum"],
              owned_mrr_equal=own["val_mrr"] == rep["val_mrr"]))
    if not (rep["packer_equals_serial"] and own["packer_equals_serial"]):
        raise AssertionError("multihost_train: the packer state after the "
                             "epoch is not the serial Engine's")
    return counts, wants


def phase_multihost_one(torch, pkg, attention, data, cfg_path, phase,
                        n_hosts, serial_rec, per_step):
    """One multi-host train epoch of a config at full width (replicated
    exchange) beside the serial Engine's epoch of this call; returns its
    launches and expected launches."""
    rec, eng, _, launches = _mh_train_arm(torch, pkg, attention, data,
                                          cfg_path, n_hosts, "replicated",
                                          False)
    emit(dict(phase=phase, serial_edges_per_s=serial_rec["edges_per_s"],
              serial_seconds=serial_rec["seconds"], **rec))
    return launches, _mh_want(rec, per_step)


def phase_multihost_host_only(torch, pkg, attention, data, cfg_path):
    """The host work of a multi-host epoch alone (host_only: range packs,
    exchange, re-plan, composition; no device step) with TGN-memory.yml
    at 2 and 4 hosts, replicated against owned: each arm's trace, host_s
    the work one host of such a deployment would do.  No kernel may
    launch."""
    for n_hosts in (2, 4):
        arms = {}
        for exchange in ("replicated", "owned"):
            cfg = pkg.parse_config(cfg_path)
            eng = pkg.MultiHostEngine(data, cfg, n_hosts=n_hosts,
                                      exchange=exchange)
            eng.warm_buckets()
            eng._warmed = True
            reset_counts(attention)
            stats = eng.train_epoch(host_only=True)
            if any(counts_now(attention).values()) or eng._step:
                raise AssertionError(f"host_only launched "
                                     f"{counts_now(attention)}")
            arms[exchange] = dict(events=stats["events"],
                                  **eng.last_epoch_trace)
            del eng
        emit(dict(phase="multihost_host_only", config="TGN-memory.yml",
                  n_hosts=n_hosts, **arms,
                  owned_over_replicated_host_s=arms["owned"]["host_s"]
                  / arms["replicated"]["host_s"]))


# ------------------------------------------------------ the sharded engine
SHARDED_TOL = 1e-6            # GPU against CPU at world size 1: a step's
                              # loss and mem, |a - b| <= tol + tol·|b|
SHARDED_RTOL = 2e-4           # dp = 2 against the serial engine (the CPU
                              # tests' bound, tests/test_parallel.py:126)
# full width at dp = 2 against the serial arm: the epoch loss and the val
# MRR within the prediction written before the first run (PERF.md §6)
TWO_RANK_BOUND = dict(loss_rel=5e-3, mrr_abs=5e-3)
# the first step's gradient vector at dp = 2 (after the dp sum) against
# the serial arm's, ||g - g_serial|| / ||g_serial|| over every parameter
# at once (one parameter's own norm can be a sum that nearly cancels, as
# the score head's bias is, and then the summation order alone moves its
# share by 1e-4): float summation order moves it by ~1e-7 (PERF.md §6)
GRAD_RTOL = 1e-4
# faults planted in a control arm of sharded_two_rank_train: the gradient
# check must catch each (a gap past GRAD_RTOL)
FAULTS = ("grad_mean", "no_reduce_scatter")
WORKER_TIMEOUT_S = 420


def first_step_grads(eng):
    """Wrap ``eng.optimizer.step``: the gradients it is handed first (the
    sharded engine's after its dp sum), on the host, by parameter name."""
    grads, step = {}, eng.optimizer.step

    def first(*args, **kw):
        if not grads:
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in eng.model.named_parameters()
                          if p.grad is not None})
        return step(*args, **kw)

    eng.optimizer.step = first
    return grads


def grad_gap(got, want) -> float:
    """||got - want|| / ||want|| over every parameter at once (inf when they
    name other parameters or none)."""
    import torch
    if not want or set(got) != set(want):
        return float("inf")
    diff = torch.cat([(got[k] - w).reshape(-1) for k, w in want.items()])
    norm = torch.cat([w.reshape(-1) for w in want.values()]).norm()
    return float(diff.norm() / norm.clamp_min(1e-30))


@contextlib.contextmanager
def planted(fault, eng):
    """A control arm's fault while inside: ``grad_mean`` divides the dp sum
    of the gradients by dp; ``no_reduce_scatter`` gives each rank's rows of
    the gathered table the gradient of its own events alone."""
    from tgb_tgn_dgl_tpu_torch.parallel import mesh as mesh_mod
    sum_grads, backward = eng._sum_grads, mesh_mod._GatherRows.backward
    if fault == "grad_mean":
        def mean():
            sum_grads()
            for p in eng.model.parameters():
                if p.grad is not None:
                    p.grad.div_(eng.mesh.dp)
        eng._sum_grads = mean
    elif fault == "no_reduce_scatter":
        mesh_mod._GatherRows.backward = staticmethod(
            lambda ctx, grad: (grad[ctx.mesh.share(grad.shape[0], ctx.axis)],
                               None, None))
    elif fault is not None:
        raise ValueError(f"fault {fault!r}")
    try:
        yield
    finally:
        eng._sum_grads = sum_grads
        mesh_mod._GatherRows.backward = backward


def _close(a, b, tol):
    return abs(a - b) <= tol + tol * abs(b)


def _group(torch, backend, tmp, name):
    """A process group of one (the tiny runs' world size 1) through a file
    store in ``tmp``."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{tmp}/{name}",
                            world_size=1, rank=0)


def _tiny_sharded_run(torch, pkg, raw, dev, sharded=False,
                      mesh=None):
    """One epoch, the val and the test pass of the tiny stream: (engine,
    step losses, stats, val, test, whole memory state or None)."""
    if sharded:
        eng = pkg.ShardedEngine(_tiny(pkg), pkg.parse_config_dict(raw),
                                mesh=mesh, device=dev)
    else:
        eng = pkg.Engine(_tiny(pkg), pkg.parse_config_dict(raw), device=dev)
    losses = _recorder(eng)
    stats = eng.train_epoch()
    val, test = eng.evaluate("val"), eng.evaluate("test")
    mem = None
    if eng.use_memory:
        mem = eng.full_memory_state() if sharded else eng.mem_state
    return eng, losses, stats, val, test, mem


def phase_sharded_reference(torch, pkg, attention, tmp):
    """ShardedEngine at world size 1 on the tiny stream at dropout 0, for
    frozen TGN, the memory and JODIE: on the GPU over NCCL bit-equal to the
    serial GPU Engine (both under torch.use_deterministic_algorithms:
    per-step losses, stats, val and test MRR, parameters, MemoryState),
    and equal to the CPU ShardedEngine over gloo within SHARDED_TOL (a
    step's loss, mem; MRR within MRR_TOL).  Returns the GPU sharded runs'
    launches, which must equal the serial runs'."""
    import torch.distributed as dist
    from tgb_tgn_dgl_tpu_torch.parallel.mesh import make_mesh
    cases = (("frozen", REFERENCE_RAW), ("memory", MEMORY_RAW),
             ("jodie", _arch_raw("identity")))
    gpu, launches = {}, {}
    _group(torch, "nccl", tmp, "nccl_store")
    try:
        nccl = _nccl_calls(torch, dist)
        mesh = make_mesh(backend="nccl")
        for name, raw in cases:
            for sharded in (False, True):
                attention.reset_launch_counts()
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    gpu[name, sharded] = _tiny_sharded_run(
                        torch, pkg, raw, "cuda", sharded, mesh)
                finally:
                    torch.use_deterministic_algorithms(False)
                launches[name, sharded] = dict(attention.launch_counts)
    finally:
        dist.destroy_process_group()
    cpu = {}
    _group(torch, "gloo", tmp, "gloo_store")
    try:
        mesh = make_mesh(backend="gloo")
        for name, raw in cases:
            cpu[name] = _tiny_sharded_run(torch, pkg, raw, "cpu", True, mesh)
    finally:
        dist.destroy_process_group()
    for name, _ in cases:
        s_eng, s_l, s_st, s_v, s_t, s_mem = gpu[name, False]
        g_eng, g_l, g_st, g_v, g_t, g_mem = gpu[name, True]
        c_eng, c_l, c_st, c_v, c_t, c_mem = cpu[name]
        bit = (s_l == g_l and s_st == g_st and (s_v, s_t) == (g_v, g_t)
               and all(torch.equal(a, b) for a, b in zip(
                   s_eng.model.parameters(), g_eng.model.parameters()))
               and (s_mem is None or all(torch.equal(a, b) for a, b in
                                         zip(s_mem, g_mem))))
        res = dict(phase="sharded_reference", config=name,
                   mesh=g_eng.mesh.shape, nccl_calls=nccl, steps=len(g_l),
                   bit_equal_serial_gpu=bit,
                   losses_gpu=g_l, losses_cpu=c_l,
                   max_loss_diff=max(abs(a - b) for a, b in zip(g_l, c_l)),
                   mrr_gpu=g_v, mrr_cpu=c_v, test_mrr_gpu=g_t,
                   test_mrr_cpu=c_t, tol=SHARDED_TOL, mrr_tol=MRR_TOL,
                   launches_gpu=launches[name, True],
                   launches_serial_gpu=launches[name, False])
        ok = (bit and len(g_l) == len(c_l) == 6
              and all(_close(a, b, SHARDED_TOL) for a, b in zip(g_l, c_l))
              and abs(g_v - c_v) <= MRR_TOL and abs(g_t - c_t) <= MRR_TOL
              and launches[name, True] == launches[name, False])
        if g_mem is not None:
            res["max_mem_diff"] = float((g_mem.mem.cpu() - c_mem.mem)
                                        .abs().max())
            res["unequal_state_fields"] = [
                f for f in g_mem._fields if f != "mem" and not torch.equal(
                    getattr(g_mem, f).cpu(), getattr(c_mem, f))]
            ok = ok and bool(((g_mem.mem.cpu() - c_mem.mem).abs()
                              <= SHARDED_TOL + SHARDED_TOL
                              * c_mem.mem.abs()).all()) \
                and not res["unequal_state_fields"]
        emit(res)
        if not ok:
            raise AssertionError(f"sharded_reference {name}: the sharded "
                                 f"engine departs from the serial GPU engine"
                                 f" or from the CPU")


def _nccl_calls(torch, dist):
    """The mesh's NCCL calls on CUDA tensors in the group of one (the mesh
    itself makes none at an axis of one): an all-gather of raw bytes, a
    sum and a reduce-scatter, each of which must return its input."""
    x = torch.arange(12, dtype=torch.float32, device="cuda").view(3, 4)
    raw = x.view(torch.uint8)
    out = torch.empty_like(raw)
    dist.all_gather_into_tensor(out, raw)
    s = x.clone()
    dist.all_reduce(s)
    rs = torch.empty_like(x)
    dist.reduce_scatter_tensor(rs, x)
    ok = (torch.equal(out.view(torch.float32), x) and torch.equal(s, x)
          and torch.equal(rs, x))
    if not ok:
        raise AssertionError("NCCL calls in a group of one changed data")
    return ["all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor"]


def _hash(torch, t):
    """An order-sensitive checksum of a tensor's bits."""
    if t.numel() == 0:
        return 0
    b = t.detach().contiguous().reshape(-1).view(torch.uint8).to(torch.int64)
    w = torch.arange(1, b.numel() + 1, device=b.device) % 65521 + 1
    return int((b * w).sum())


def _op_trace(torch):
    """A dispatch mode that records (op, input checksums, output checksums)
    for every aten op in order."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Trace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = [_hash(torch, a) for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            out = func(*args, **kwargs)
            # an empty tensor's bits are whatever the allocator left
            outs = [] if "empty" in str(func) else [
                _hash(torch, a) for a in tree_flatten(out)[0]
                if isinstance(a, torch.Tensor)]
            self.ops.append((str(func), ins, outs))
            return out

    return Trace()


def _first_divergence(a, b):
    """The first op whose inputs agree across two traces and whose outputs
    do not (the op that is not reproducible), else the first op whose
    inputs differ (a difference from outside aten, e.g. a ctypes
    kernel)."""
    for i, ((fa, ia, oa), (fb, ib, ob)) in enumerate(zip(a, b)):
        if fa != fb:
            return dict(index=i, op=fa, other=fb, kind="op sequence")
        if ia != ib:
            return dict(index=i, op=fa, kind="inputs differ")
        if oa != ob:
            return dict(index=i, op=fa, kind="outputs differ")
    return None


def phase_nondeterminism(torch, pkg):
    """Which CUDA op of the memory path does not repeat bit for bit: one
    train step of the tiny memory stream, the serial Engine's (batch 100)
    and MultiHostEngine's composed step (2 x 100 events), each run twice
    from the same seed in the default mode and twice under
    torch.use_deterministic_algorithms(True); every gradient, parameter
    and MemoryState field hashed, and the default runs' aten ops traced
    (inputs and outputs hashed) to name the ops whose outputs differ on
    equal inputs."""
    def one_step(multihost, det):
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            raw = pkg.parse_config_dict(MEMORY_RAW)
            if multihost:
                eng = pkg.MultiHostEngine(_tiny(pkg), raw, n_hosts=2,
                                          device="cuda")
                name = "_composed_step"
            else:
                raw.train.sanity_batches = 1
                eng = pkg.Engine(_tiny(pkg), raw, device="cuda")
                name = "_train_step"
            mode = None if det else _op_trace(torch)
            step = getattr(eng, name)

            def traced(*args):
                if mode is None:
                    return step(*args)
                with mode:
                    out = step(*args)
                    torch.cuda.synchronize()
                return out

            setattr(eng, name, traced)
            if multihost:
                eng.train_epoch(max_super_batches=1)
            else:
                eng.train_epoch()
            torch.cuda.synchronize()
            hashes = {f"grad {n}": _hash(torch, p.grad)
                      for n, p in eng.model.named_parameters()
                      if p.grad is not None}
            hashes.update({f"param {n}": _hash(torch, p)
                           for n, p in eng.model.named_parameters()})
            hashes.update({f"mem_state {f}": _hash(torch, t) for f, t in
                           zip(eng.mem_state._fields, eng.mem_state)})
            return hashes, (mode.ops if mode else None)
        finally:
            torch.use_deterministic_algorithms(False)

    for path, multihost in (("serial", False), ("multihost_composed", True)):
        res = dict(phase="nondeterminism", path=path,
                   events=200 if multihost else 100)
        for label, det in (("default", False), ("deterministic", True)):
            (ha, ta), (hb, tb) = one_step(multihost, det), \
                one_step(multihost, det)
            res[label] = dict(differ=[k for k in ha if ha[k] != hb.get(k)],
                              hashed=len(ha))
            if ta is not None:
                res[label].update(
                    ops_traced=len(ta),
                    first_divergence=_first_divergence(ta, tb),
                    unrepeatable_ops=sorted({
                        fa for (fa, ia, oa), (_, ib, ob) in zip(ta, tb)
                        if ia == ib and oa != ob}))
        emit(res)
        if res["deterministic"]["differ"]:
            raise AssertionError(f"nondeterminism {path}: the deterministic"
                                 f" mode does not repeat")


def _spawn_workers(tmp, spec, world=2):
    """Run ``python3 chip_smoke.py --sharded-worker`` on ``world`` ranks
    over gloo (one card: NCCL refuses two ranks on one device); every
    rank must exit 0 within WORKER_TIMEOUT_S; returns each rank's
    results.  No process outlives the call."""
    import torch
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(dict(spec, tmp=tmp, world=world), f)
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--sharded-worker", path, str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        for r in bad:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                print(f"--- rank {r} ---\n{f.read()[-6000:]}", flush=True)
        raise AssertionError(f"ranks {bad} failed")
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _worker_engine_job(torch, pkg, attention, mesh, job, rank):
    """One engine job of a worker: the tiny stream (MEMORY_RAW at dropout
    0, deterministic mode) or a config at full width with dropout 0."""
    import dataclasses
    if job["data"] == "tiny":
        data, cfg = _tiny(pkg), pkg.parse_config_dict(MEMORY_RAW)
    else:
        data = pkg.synthetic(job["data"])
        cfg = pkg.parse_config(job["config"])
        cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(
            cfg.gnn, override_dropout=0.0))
    with _rows_seen() as rows:
        torch.use_deterministic_algorithms(job["deterministic"],
                                           warn_only=True)
        try:
            eng = pkg.ShardedEngine(data, cfg, mesh=mesh, device="cuda")
            if job.get("warm"):
                eng.warm_buckets()
                eng._warmed = True
            losses = _recorder(eng)
            grads = first_step_grads(eng)
            attention.reset_launch_counts()
            mesh.stats.update(calls=0, bytes=0, seconds=0.0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with planted(job.get("fault"), eng):
                stats = eng.train_epoch()
            torch.cuda.synchronize()
            out = dict(rank=rank, mesh=mesh.shape, losses=losses, stats=stats,
                       grads=grads, fault=job.get("fault"),
                       train_s=time.perf_counter() - t0,
                       trace=dict(eng.last_epoch_trace),
                       train_collectives=dict(mesh.stats),
                       train_launches=dict(attention.launch_counts),
                       train_rows=sorted(rows["train"]))
            attention.reset_launch_counts()
            mesh.stats.update(calls=0, bytes=0, seconds=0.0)
            t0 = time.perf_counter()
            out["val"] = eng.evaluate("val")
            torch.cuda.synchronize()
            out.update(val_s=time.perf_counter() - t0,
                       eval_trace=_eval_record(eng.last_eval_trace),
                       val_collectives=dict(mesh.stats),
                       val_launches=dict(attention.launch_counts),
                       eval_rows=sorted(rows["eval"]),
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
            if job["data"] == "tiny":
                out["params"] = {k: v.cpu() for k, v in
                                 eng.model.state_dict().items()}
                out["mem"] = {k: v.cpu() for k, v in
                              eng.full_memory_state()._asdict().items()}
            return out
        finally:
            torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def _rows_seen():
    """The root slots each attention call takes while inside, by train
    (a gradient to compute) and eval: the sets of R it launched at."""
    import tgb_tgn_dgl_tpu_torch.models.tgnn as tgnn
    rows = {"train": set(), "eval": set()}
    core = tgnn.attention_core

    def recorded(el, er, mask, slope, drop_mask=None):
        rows["train" if el.requires_grad else "eval"].add(el.shape[0])
        return core(el, er, mask, slope, drop_mask=drop_mask)

    tgnn.attention_core = recorded
    try:
        yield rows
    finally:
        tgnn.attention_core = core


def _worker_global_wire(torch, pkg, mesh, rank):
    """make_process_global_wire on the card: each rank packs its range of a
    2-host super-batch; the loss on the gathered wire, on the GPU, against
    the mean of the per-host losses."""
    import numpy as np
    from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
    from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
    from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig
    from tgb_tgn_dgl_tpu_torch.engine.negatives import NegLinkSamplerDest
    from tgb_tgn_dgl_tpu_torch.models.tgnn import (TGNNConfig, bce_loss,
                                                   init_tgnn, tgnn_forward)
    from tgb_tgn_dgl_tpu_torch.ops.wire import expand_wire, wire_to_device
    from tgb_tgn_dgl_tpu_torch.parallel.multihost import (
        align_wires, make_process_global_wire, offset_wire_for_host)
    data = pkg.synthetic("mh-2proc", num_edges=600, num_nodes=120,
                         msg_dim=4, num_neg=2, seed=33)
    B, K, IW, N = 64, 5, 8, data.num_nodes
    rows = np.nonzero(data.train_mask)[0]
    cfg = PackerConfig(num_neighbors=K, batch_size=B, max_intra_block=IW,
                       root_bucket_lo=512)
    mcfg = TGNNConfig(edge_feat_dim=data.msg_dim, hidden_dim=16, num_heads=2,
                      feat_drop=0.0, attn_drop=0.0, const_ones_memory=True)
    model = init_tgnn(mcfg, torch.Generator().manual_seed(0)).cuda()
    feats = torch.from_numpy(np.asarray(data.msg, np.float32)).cuda()
    sampler = NegLinkSamplerDest(data.unique_dst(), seed=5)

    def loss_of(wire):
        with torch.no_grad():
            pack = expand_wire(wire_to_device(wire, "cuda"), K, IW, N)
            pos, neg = tgnn_forward(model, mcfg, None, feats, pack,
                                    train=False)
            return float(bce_loss(pos, neg, pack.ev_valid))

    wires, losses = [], []
    for h in range(2):
        idx = rows[h * B:(h + 1) * B]
        src, dst, t = data.src[idx], data.dst[idx], data.t[idx]
        w, _ = NativeStreamPacker(N, cfg).pack_wire(
            src, dst, t, idx, get_block(src, dst), sampler.sample(dst))
        wires.append(w)
        losses.append(loss_of(w))
    wires = [offset_wire_for_host(w, h, 2)
             for h, w in enumerate(align_wires(wires))]
    glob = loss_of(make_process_global_wire(mesh, wires[rank]))
    return dict(global_loss=glob, host_losses=losses,
                ok=abs(glob - 0.5 * sum(losses)) < 1e-5)


def _worker_owned_exchange(pkg, rank):
    """DistributedOwnerExchange over multihost_allgather, one owner a rank
    (numpy and native), 3 super-batches: every field of the wire packed
    from the exchanged rows equal to the serial pack."""
    import numpy as np
    from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
    from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
    from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig
    from tgb_tgn_dgl_tpu_torch.parallel.multihost import multihost_allgather
    from tgb_tgn_dgl_tpu_torch.parallel.owned_state import (
        DistributedOwnerExchange, NativeNodeRangeOwnedState,
        NodeRangeOwnedState, pack_with_gathered_state)
    data = pkg.synthetic("owned-2proc", num_edges=900, num_nodes=140,
                         msg_dim=4, num_neg=2, seed=57)
    B, K, S, N = 75, 5, 2, data.num_nodes
    cfg = PackerConfig(num_neighbors=K, batch_size=B, max_intra_block=8,
                       mailbox_size=S)
    unequal = []
    for kind, cls in (("numpy", NodeRangeOwnedState),
                      ("native", NativeNodeRangeOwnedState)):
        serial, scratch = NativeStreamPacker(N, cfg), NativeStreamPacker(
            N, cfg)
        scratch._sticky = serial._sticky
        owner = cls(N, 2, rank, K, S)
        ex = DistributedOwnerExchange(owner, rank, 2, multihost_allgather)
        rng = np.random.default_rng(3)
        for sb in range(3):
            batches = []
            for h in range(2):
                idx = np.arange((2 * sb + h) * B, (2 * sb + h + 1) * B)
                src, dst = data.src[idx], data.dst[idx]
                batches.append((src, dst, data.t[idx], idx,
                                get_block(src, dst),
                                rng.integers(0, N, B).astype(np.int32)))
            got, _, _ = pack_with_gathered_state(scratch, [ex],
                                                 *batches[rank])
            snap = serial.snapshot()
            want, _ = serial.pack_wire(*batches[rank])
            unequal += [f"{kind} sb {sb} {f}" for f in type(want)._fields
                        if not np.array_equal(np.asarray(getattr(want, f)),
                                              np.asarray(getattr(got, f)))]
            serial.restore(snap)
            for b in batches:
                serial.pack_wire(*b)
                owner.apply_batch(b[0], b[1], b[2], b[4], b[5], e_id=b[3])
    return dict(unequal=unequal, ok=not unequal)


def sharded_worker(spec_path, rank) -> int:
    """One rank of a two-process run on the one card (gloo, cuda:0)."""
    import torch
    import torch.distributed as dist
    from tgb_tgn_dgl_tpu_torch.ops import attention
    from tgb_tgn_dgl_tpu_torch.parallel.mesh import Mesh
    from tgb_tgn_dgl_tpu_torch.parallel.multihost import init_distributed
    pkg = _package()
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    init_distributed(f"file://{spec['tmp']}/store", spec["world"], rank,
                     "gloo")
    try:
        out = []
        for job in spec["jobs"]:
            if job["kind"] == "engine":
                out.append(_worker_engine_job(
                    torch, pkg, attention, Mesh(job["dp"], job["state"]),
                    job, rank))
            elif job["kind"] == "global_wire":
                out.append(_worker_global_wire(torch, pkg, Mesh(2, 1), rank))
            else:
                out.append(_worker_owned_exchange(pkg, rank))
        torch.save(out, os.path.join(spec["tmp"], f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _serial_tiny_gpu(torch, pkg, attention):
    """The serial GPU Engine on the tiny memory stream at dropout 0 under
    deterministic algorithms: (losses, stats, val, params, mem,
    launches, the first step's gradients)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        attention.reset_launch_counts()
        eng = pkg.Engine(_tiny(pkg), pkg.parse_config_dict(MEMORY_RAW),
                         device="cuda")
        losses = _recorder(eng)
        grads = first_step_grads(eng)
        stats = eng.train_epoch()
        val = eng.evaluate("val")
        return (losses, stats, val,
                {k: v.cpu() for k, v in eng.model.state_dict().items()},
                {k: v.cpu() for k, v in eng.mem_state._asdict().items()},
                dict(attention.launch_counts), grads)
    finally:
        torch.use_deterministic_algorithms(False)


def phase_sharded_two_rank(torch, pkg, attention, tmp):
    """Two processes on the one card over gloo (NCCL refuses two ranks on
    one device): ShardedEngine on the tiny memory stream at dropout 0
    under deterministic algorithms at dp = 2, state = 1 and dp = 1,
    state = 2, against the serial GPU Engine: dp = 1, state = 2 bit-equal
    (losses, stats, val MRR, parameters, MemoryState), dp = 2 within
    SHARDED_RTOL (epoch loss, val MRR); both at the first step's gradients
    within GRAD_RTOL of the serial ones; the ranks equal each other; then
    make_process_global_wire (the loss on the gathered wire the mean of
    the hosts' within 1e-5) and DistributedOwnerExchange (wires equal to
    the serial pack)."""
    jobs = [dict(kind="engine", data="tiny", dp=dp, state=st,
                 deterministic=True) for dp, st in ((2, 1), (1, 2))]
    jobs += [dict(kind="global_wire"), dict(kind="owned_exchange")]
    t0 = time.perf_counter()
    ranks = _spawn_workers(tmp, dict(jobs=jobs))
    seconds = time.perf_counter() - t0
    s_l, s_st, s_v, s_p, s_m, s_launch, s_g = _serial_tiny_gpu(
        torch, pkg, attention)
    for j, (dp, st) in enumerate(((2, 1), (1, 2))):
        r0, r1 = ranks[0][j], ranks[1][j]
        same_ranks = (r0["losses"] == r1["losses"] and r0["val"] == r1["val"]
                      and all(torch.equal(v, r1["params"][k])
                              for k, v in r0["params"].items()))
        bit = (r0["losses"] == s_l and r0["stats"] == s_st
               and r0["val"] == s_v
               and all(torch.equal(v, r0["params"][k]) for k, v in s_p.items())
               and all(torch.equal(v, r0["mem"][k]) for k, v in s_m.items()))
        rel = abs(r0["stats"]["loss"] - s_st["loss"]) / abs(s_st["loss"])
        gap = max(grad_gap(r["grads"], s_g) for r in (r0, r1))
        res = dict(phase="sharded_two_rank", mesh=r0["mesh"], backend="gloo",
                   ranks=2, device="cuda:0 (both ranks)",
                   seconds=seconds, loss=r0["stats"]["loss"],
                   serial_loss=s_st["loss"], loss_rel_diff=rel,
                   val=r0["val"], serial_val=s_v, bit_equal_serial=bit,
                   ranks_equal=same_ranks, rtol=SHARDED_RTOL,
                   first_step_grad_gap=gap, grad_rtol=GRAD_RTOL,
                   launches_rank0=r0["train_launches"],
                   serial_train_launches=s_launch,
                   train_rows=[r0["train_rows"], r1["train_rows"]],
                   collectives=r0["train_collectives"])
        ok = same_ranks and gap <= GRAD_RTOL and (bit if dp == 1 else (
            rel <= SHARDED_RTOL and _close(r0["val"], s_v, SHARDED_RTOL)))
        emit(res)
        if not ok:
            raise AssertionError(f"sharded_two_rank {r0['mesh']}: departs "
                                 f"from the serial GPU engine")
    gw = [r[2] for r in ranks]
    ox = [r[3] for r in ranks]
    emit(dict(phase="sharded_two_rank", check="make_process_global_wire",
              ranks=gw))
    emit(dict(phase="sharded_two_rank", check="DistributedOwnerExchange",
              ranks=ox))
    if not all(r["ok"] for r in gw + ox):
        raise AssertionError("sharded_two_rank: the global wire or the "
                             "owned exchange failed its check")


def _cli_arm(torch, attention, root, cfg_path, flags):
    """One CLI run (one epoch and its val pass) at full width: the engine,
    its record and its launches counted from 0."""
    from tgb_tgn_dgl_tpu_torch.run_tgn import main
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    t0 = time.perf_counter()
    out = main(["--data", "tgbl-wiki", "--synthetic", "--config", cfg_path,
                "--epochs", "1", *flags])
    torch.cuda.synchronize()
    eng, hist = out["engine"], out["histories"][0]
    tr = eng.last_epoch_trace
    ev = eng.last_eval_trace
    rec = dict(wall_s=time.perf_counter() - t0, loss_sum=hist["loss"][0],
               train_s=hist["train_s"][0], val=hist["val"][0],
               val_s=hist["val_s"][0],
               edges_per_s=float(eng.data.train_mask.sum())
               / hist["train_s"][0],
               pack_s=tr["pack_s"], fetch_s=tr["fetch_s"],
               copy_s=tr["copy_s"], disp_s=tr["disp_s"],
               eval=_eval_record(ev),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return eng, rec, dict(attention.launch_counts)


def phase_sharded_train(torch, attention, root, cfg_path):
    """The CLI at full width, configs/TGN-memory.yml on the tgbl-wiki-shaped
    stream, ``--engine sharded --dp 1 --state-ax 1`` (world size 1, no
    process group: no collective), beside the serial CLI arm of this
    call: one epoch after the bucket warm-up and the slot-unique val pass
    each; the loss sum and val MRR equal to the serial arm's, and the same
    launches.  Returns the sharded arm's launches and the serial arm's."""
    eng_s, serial, serial_launch = _cli_arm(torch, attention, root, cfg_path,
                                            [])
    del eng_s
    eng, sharded, launches = _cli_arm(
        torch, attention, root, cfg_path,
        ["--engine", "sharded", "--dp", "1", "--state-ax", "1"])
    if type(eng).__name__ != "ShardedEngine":
        raise AssertionError("the CLI did not build a ShardedEngine")
    res = dict(phase="sharded_train", config="TGN-memory.yml",
               mesh=eng.mesh.shape, sharded=sharded, serial=serial,
               loss_equal=sharded["loss_sum"] == serial["loss_sum"],
               val_equal=sharded["val"] == serial["val"],
               launches=launches, serial_launches=serial_launch)
    emit(res)
    if not (res["loss_equal"] and res["val_equal"]
            and sharded["eval"]["protocol"] == "slot_unique"
            and launches == serial_launch):
        raise AssertionError("sharded_train: the sharded CLI run departs "
                             "from the serial arm")
    return launches, serial_launch


def phase_sharded_two_rank_train(torch, pkg, attention, tmp, data,
                                 cfg_path):
    """configs/TGN-memory.yml at full width with dropout 0, dp = 2 on the
    one card over gloo (two processes, every collective staged through
    the host): the warmed epoch and the slot-unique val pass on each rank,
    with the collectives' host seconds apart, beside a serial arm of this
    process at the same dropout 0.  Each rank launches what the serial arm
    launches, at half its root slots.  The first step's gradients must be
    within GRAD_RTOL of the serial arm's, the epoch loss and the val MRR
    within TWO_RANK_BOUND.  A control arm a fault of FAULTS runs the same
    job with the fault planted: the gradient check must catch each, and
    whether the loss and MRR bound alone would is reported.  Returns the
    ranks' launches and the serial arm's."""
    import dataclasses
    import math
    jobs = [dict(kind="engine", data="tgbl-wiki", config=cfg_path, dp=2,
                 state=1, deterministic=False, warm=True, fault=fault)
            for fault in (None, *FAULTS)]
    t0 = time.perf_counter()
    ranks = _spawn_workers(tmp, dict(jobs=jobs))
    seconds = time.perf_counter() - t0
    cfg = pkg.parse_config(cfg_path)
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(
        cfg.gnn, override_dropout=0.0))
    eng = pkg.Engine(data, cfg)
    eng.warm_buckets()
    eng._warmed = True
    grads = first_step_grads(eng)
    with _rows_seen() as rows:
        attention.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = eng.train_epoch()
        torch.cuda.synchronize()
        serial = dict(loss=stats["loss"], train_s=time.perf_counter() - t0,
                      trace=dict(eng.last_epoch_trace))
        train_launch = dict(attention.launch_counts)
        attention.reset_launch_counts()
        t0 = time.perf_counter()
        serial["val"] = eng.evaluate("val")
        torch.cuda.synchronize()
        serial.update(val_s=time.perf_counter() - t0,
                      eval=_eval_record(eng.last_eval_trace),
                      train_rows=sorted(rows["train"]),
                      eval_rows=sorted(rows["eval"]))
        val_launch = dict(attention.launch_counts)
    del eng

    def gaps(j):
        """Arm j's loss and MRR gaps and its first-step gradient gap (the
        larger of the two ranks')."""
        a, b = ranks[0][j], ranks[1][j]
        return dict(loss_rel=abs(a["stats"]["loss"] - serial["loss"])
                    / abs(serial["loss"]),
                    mrr_abs=abs(a["val"] - serial["val"]),
                    grad_rel=max(grad_gap(a["grads"], grads),
                                 grad_gap(b["grads"], grads)))

    r0, r1 = ranks[0][0], ranks[1][0]
    sound = gaps(0)
    rel, dmrr = sound["loss_rel"], sound["mrr_abs"]
    controls = {}
    for j, fault in enumerate(FAULTS, 1):
        c = gaps(j)
        controls[fault] = dict(
            c, caught_by_grads=c["grad_rel"] > GRAD_RTOL,
            caught_by_loss_or_mrr=c["loss_rel"] > TWO_RANK_BOUND["loss_rel"]
            or c["mrr_abs"] > TWO_RANK_BOUND["mrr_abs"])
    half = [-(-max(serial["train_rows"]) // 2),
            -(-max(serial["eval_rows"]) // 2)]
    res = dict(phase="sharded_two_rank_train", config="TGN-memory.yml",
               dropout=0.0, mesh=r0["mesh"], backend="gloo", ranks=2,
               seconds=seconds, serial=serial,
               rank0={k: r0[k] for k in (
                   "stats", "train_s", "val", "val_s", "trace", "eval_trace",
                   "train_collectives", "val_collectives", "peak_mem_gb",
                   "train_rows", "eval_rows")},
               rank1_train_s=r1["train_s"], rank1_val_s=r1["val_s"],
               loss_rel_diff=rel, val_abs_diff=dmrr,
               first_step_grad_gap=sound["grad_rel"], grad_rtol=GRAD_RTOL,
               bound=TWO_RANK_BOUND, controls=controls,
               launches_rank=[r0["train_launches"], r0["val_launches"]],
               launches_serial=[train_launch, val_launch],
               half_rows=half)
    emit(res)
    ok = (math.isfinite(r0["stats"]["loss"])
          and r0["stats"] == r1["stats"] and r0["val"] == r1["val"]
          and rel <= TWO_RANK_BOUND["loss_rel"]
          and dmrr <= TWO_RANK_BOUND["mrr_abs"]
          and sound["grad_rel"] <= GRAD_RTOL
          and all(c["caught_by_grads"] for c in controls.values())
          and r0["train_launches"] == r1["train_launches"] == train_launch
          and r0["val_launches"] == r1["val_launches"] == val_launch
          and max(r0["train_rows"]) == half[0]
          and max(r0["eval_rows"]) == half[1])
    if not ok:
        raise AssertionError("sharded_two_rank_train: the ranks disagree, "
                             "depart from the serial arm past the bound, "
                             "launch otherwise, or a planted fault passes "
                             "the gradient check")
    return ([r0["train_launches"], r0["val_launches"]],
            [train_launch, val_launch])


def _package():
    """The port's entry points the phases drive."""
    from types import SimpleNamespace

    from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
    from tgb_tgn_dgl_tpu_torch.engine.train import Engine
    from tgb_tgn_dgl_tpu_torch.parallel.engine import ShardedEngine
    from tgb_tgn_dgl_tpu_torch.parallel.mh_engine import MultiHostEngine
    from tgb_tgn_dgl_tpu_torch.utils.config import (parse_config,
                                                    parse_config_dict)
    return SimpleNamespace(synthetic=synthetic, Engine=Engine,
                           MultiHostEngine=MultiHostEngine,
                           ShardedEngine=ShardedEngine,
                           parse_config=parse_config,
                           parse_config_dict=parse_config_dict)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "tgb_tgn_dgl_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    from tgb_tgn_dgl_tpu_torch.ops import _build, attention, gather
    pkg = _package()
    synthetic = pkg.synthetic
    phase = "device"
    try:
        smi = nvidia_smi_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        # g++ for the host libraries runs beside nvcc for the kernels
        with ThreadPoolExecutor(2) as pool:
            hosts = {name: pool.submit(_build.build_host, name)
                     for name in _build.host_sources()}
            report = _build.build()
            hosts = {name: f.result() for name, f in hosts.items()}
        emit(dict(phase="device", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count(), nvidia_smi=smi,
                  torch=torch.__version__, cuda=torch.version.cuda,
                  tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
                  tf32_cudnn=torch.backends.cudnn.allow_tf32,
                  build_s=time.perf_counter() - t0,
                  packer_build_s=hosts["packer"]["seconds"],
                  hostops_build_s=hosts["hostops"]["seconds"],
                  owned_state_build_s=hosts["owned_state"]["seconds"],
                  cxx=_build.compiler_version(),
                  build={k: dict(seconds=v["seconds"],
                                 ptxas=[l for l in v["log"].splitlines()
                                        if "registers" in l or "spill" in l])
                         for k, v in report.items()}))
        phase = "kernels"
        kres = phase_kernels(torch, attention, gather)
        phase = "reference"
        phase_reference(torch, pkg)
        phase = "memory_reference"
        phase_memory_reference(torch, pkg)
        phase = "layer2_reference"
        phase_layer2_reference(torch, pkg)
        phase = "vector_reference"
        phase_vector_reference(torch, pkg)
        phase = "jodie_reference"
        phase_jodie_reference(torch, pkg)
        phase = "dyrep_reference"
        phase_dyrep_reference(torch, pkg)
        phase = "uniform_reference"
        phase_uniform_reference(torch, pkg)
        phase = "bf16_reference"
        phase_bf16_reference(torch, pkg)
        phase = "device_cache_reference"
        phase_device_cache_reference(torch, pkg)
        phase = "train_lean_reference"
        phase_train_lean_reference(torch, pkg)
        phase = "multihost_reference"
        phase_multihost_reference(torch, pkg, attention)
        phase = "nondeterminism"
        phase_nondeterminism(torch, pkg)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase = "sharded_reference"
            phase_sharded_reference(torch, pkg, attention, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase = "sharded_two_rank"
            phase_sharded_two_rank(torch, pkg, attention, tmp)
        phase = "wire"
        data = synthetic("tgbl-wiki")
        cfgs = os.path.join(root, "tgb_tgn_dgl_tpu_torch", "configs")
        cfg_path = os.path.join(cfgs, "TGN.yml")
        mem_cfg_path = os.path.join(cfgs, "TGN-memory.yml")
        layer2_cfg_path = os.path.join(cfgs, "TGN-2layer.yml")
        jodie_cfg_path = os.path.join(cfgs, "JODIE.yml")
        dyrep_cfg_path = os.path.join(cfgs, "DyRep.yml")
        phase_wire(torch, data, cfg_path)
        phase = "layer2_wire"
        phase_layer2_wire(torch, data, layer2_cfg_path)
        phase = "lean_wire"
        phase_lean_wire(torch, data, mem_cfg_path)
        phase = "train_lean_wire"
        phase_train_lean_wire(torch, data, mem_cfg_path)
        phase = "train"
        reset_counts(attention)
        eng, train_rec = phase_train(torch, pkg, data, cfg_path)
        snap = _stream_state(eng)
        phase = "eval"
        unique = phase_eval(torch, eng)
        frozen_counts = counts_now(attention)
        phase = "eval_unique_vs_chunked"
        host_arms = {"": (train_rec, unique, phase_eval_unique_vs_chunked(
            torch, eng, snap, unique, phase))}
        del eng, snap
        phase = "memory_train"
        reset_counts(attention)
        eng, train_rec = phase_memory_train(torch, pkg, data, mem_cfg_path)
        memory_steps = train_rec["steps"]
        snap = _stream_state(eng)
        phase = "memory_eval"
        unique = phase_eval(torch, eng, "memory_eval")
        memory_counts = counts_now(attention)
        phase = "memory_eval_unique_vs_chunked"
        host_arms["memory_"] = (train_rec, unique,
                                phase_eval_unique_vs_chunked(
                                    torch, eng, snap, unique, phase))
        # the serial packer state after the epoch, for multihost_train
        serial_memory_packer = snap[0]
        del eng, snap
        torch.cuda.empty_cache()
        # the three knobs (each path's counts from 0, in the phases)
        phase = "uniform_train"
        knob_counts, knob_want = {}, {}
        knob_counts["uniform"], knob_want["uniform"] = phase_uniform_train(
            torch, pkg, attention, data, cfg_path,
            (host_arms[""][0], host_arms[""][2]))
        torch.cuda.empty_cache()
        phase = "bf16_train"
        counts_, want_ = phase_bf16_train(
            torch, pkg, attention, data, (("frozen", cfg_path),
                                          ("memory", mem_cfg_path)))
        knob_counts.update(counts_)
        knob_want.update(want_)
        torch.cuda.empty_cache()
        phase = "remat_train"
        knob_counts["remat"], knob_want["remat"] = phase_remat_train(
            torch, pkg, attention, data, mem_cfg_path)
        torch.cuda.empty_cache()
        # the two device-side transports beside the host-pack arms above:
        # each path's launches counted from 0
        transport_counts, transport_want = {}, {}
        for path, cfg_p, host in (("device_cache", cfg_path, ""),
                                  ("device_cache_memory", mem_cfg_path,
                                   "memory_")):
            phase = f"{path}_train"
            reset_counts(attention)
            eng = phase_transport_train(torch, pkg, data, cfg_p, phase,
                                        host_arms[host][0],
                                        device_cache=True)
            steps = eng.last_epoch_trace["batches"]
            phase = f"{path}_eval"
            dc_eval = phase_device_cache_eval(torch, eng, phase,
                                              *host_arms[host][1:])
            transport_counts[path] = counts_now(attention)
            transport_want[path] = dict(
                attention_fwd=0, attention_bwd=0, attention_fwd_drop=steps,
                attention_bwd_drop=steps,
                attention_fwd_infer=dc_eval["embed_chunks"],
                gather_bwd=2 * steps if host else 0)
            del eng
        for path, cfg_p, host in (("train_lean", cfg_path, ""),
                                  ("train_lean_memory", mem_cfg_path,
                                   "memory_")):
            phase = f"{path}_train"
            reset_counts(attention)
            eng = phase_transport_train(torch, pkg, data, cfg_p, phase,
                                        host_arms[host][0],
                                        wire_train_lean=True)
            steps = eng.last_epoch_trace["batches"]
            transport_counts[path] = counts_now(attention)
            transport_want[path] = dict(
                attention_fwd=0, attention_bwd=0, attention_fwd_drop=steps,
                attention_bwd_drop=steps, attention_fwd_infer=0,
                gather_bwd=2 * steps if host else 0)
            del eng
        torch.cuda.empty_cache()
        phase = "layer2_train"
        reset_counts(attention)
        eng, _ = phase_memory_train(torch, pkg, data, layer2_cfg_path, phase)
        layer2_steps = eng.last_epoch_trace["batches"]
        phase = "layer2_eval"
        layer2 = phase_eval(torch, eng, phase, closed_by="gnn.layer>1")
        layer2_counts = counts_now(attention)
        del eng
        phase = "vector_train"
        reset_counts(attention)
        eng, _ = phase_memory_train(torch, pkg, data, mem_cfg_path, phase,
                                    steps=VECTOR_STEPS,
                                    message_mode="vector")
        vector_steps = eng.last_epoch_trace["batches"]
        phase = "vector_eval"
        phase_eval(torch, eng, phase)
        vector_counts = counts_now(attention)
        del eng
        phase = "jodie_train"
        reset_counts(attention)
        eng, jodie_rec = phase_memory_train(torch, pkg, data, jodie_cfg_path,
                                            phase)
        phase = "jodie_eval"
        phase_eval(torch, eng, phase)
        jodie_counts = counts_now(attention)
        del eng
        phase = "dyrep_train"
        reset_counts(attention)
        eng, dyrep_rec = phase_memory_train(torch, pkg, data, dyrep_cfg_path,
                                            phase)
        dyrep_steps = eng.last_epoch_trace["batches"]
        snap = _stream_state(eng)
        phase = "dyrep_eval"
        dyrep = phase_eval(torch, eng, phase)
        dyrep_counts = counts_now(attention)
        phase = "dyrep_eval_unique_vs_chunked"
        phase_eval_unique_vs_chunked(torch, eng, snap, dyrep, phase)
        del eng, snap
        torch.cuda.empty_cache()
        phase = "decoders"
        phase_decoders(torch)
        phase = "eval_low_dedup"
        phase_eval_low_dedup(torch, pkg, cfg_path)
        phase = "device_cache_large_n"
        phase_device_cache_large_n(torch, pkg, cfg_path)
        torch.cuda.empty_cache()
        phase = "pad_mask"
        phase_pad_mask(torch, pkg)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase = "fit_reference"
            phase_fit_reference(torch, pkg, tmp)
            phase = "fit"
            fit_counts, fit_want = phase_fit(torch, root, tmp)
        torch.cuda.empty_cache()
        # the multi-host paths, each path's counts from 0 (in the phases)
        phase = "multihost_train"
        mh_counts, mh_want = phase_multihost_train(
            torch, pkg, attention, data, mem_cfg_path, host_arms["memory_"][0],
            serial_memory_packer)
        for path, cfg_p, n_hosts, serial_rec, per_step in (
                ("multihost_frozen", cfg_path, 4, host_arms[""][0], 1),
                ("multihost_jodie", jodie_cfg_path, 2, jodie_rec, 0),
                ("multihost_dyrep", dyrep_cfg_path, 2, dyrep_rec, 2)):
            phase = f"{path}_train"
            mh_counts[path], mh_want[path] = phase_multihost_one(
                torch, pkg, attention, data, cfg_p, phase, n_hosts,
                serial_rec, per_step)
        # JODIE has no attention
        mh_want["multihost_jodie"] = dict.fromkeys(
            (*attention.KERNELS, *gather.KERNELS), 0)
        phase = "multihost_host_only"
        phase_multihost_host_only(torch, pkg, attention, data, mem_cfg_path)
        torch.cuda.empty_cache()
        # the sharded engine at world size 1 beside its serial arm, then
        # at dp = 2 on two processes beside a serial arm (each arm's
        # counts from 0, in the phases)
        phase = "sharded_train"
        sharded_counts, sharded_serial = phase_sharded_train(
            torch, attention, root, mem_cfg_path)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase = "sharded_two_rank_train"
            (dp2_train, dp2_val), (dp2_want_train, dp2_want_val) = \
                phase_sharded_two_rank_train(torch, pkg, attention, tmp,
                                             data, mem_cfg_path)
        dp2_counts = {k: dp2_train[k] + dp2_val[k] for k in dp2_train}
        dp2_want = {k: dp2_want_train[k] + dp2_want_val[k]
                    for k in dp2_want_train}
        torch.cuda.empty_cache()
        phase = "counters"
        paths = dict(frozen=frozen_counts, memory=memory_counts,
                     layer2=layer2_counts, vector=vector_counts,
                     jodie=jodie_counts, dyrep=dyrep_counts, fit=fit_counts,
                     **transport_counts, **mh_counts, sharded=sharded_counts,
                     sharded_dp2_rank0=dp2_counts, **knob_counts)
        counts = {k: sum(p[k] for p in paths.values())
                  for k in attention.KERNELS}
        # the paths that count the gather backward
        counts["gather_bwd"] = sum(p.get("gather_bwd", 0)
                                   for p in paths.values())
        # two attention layers: each kernel twice a step, twice a chunk
        layer2_want = dict(attention_fwd=0, attention_bwd=0,
                           attention_fwd_drop=2 * layer2_steps,
                           attention_bwd_drop=2 * layer2_steps,
                           attention_fwd_infer=2 * layer2["embed_chunks"],
                           gather_bwd=2 * layer2_steps)
        # DyRep at att_dropout 0.1: the dropout pair once a step, the
        # inference forward once an embed chunk of its val pass
        dyrep_want = dict(attention_fwd=0, attention_bwd=0,
                          attention_fwd_drop=dyrep_steps,
                          attention_bwd_drop=dyrep_steps,
                          attention_fwd_infer=dyrep["embed_chunks"],
                          gather_bwd=2 * dyrep_steps)
        emit(dict(phase="counters", **paths, layer2_expected=layer2_want,
                  dyrep_expected=dyrep_want, fit_expected=fit_want,
                  **{f"{k}_expected": v for k, v in transport_want.items()},
                  **{f"{k}_expected": v for k, v in mh_want.items()},
                  sharded_expected=sharded_serial,
                  sharded_dp2_rank0_expected=dp2_want,
                  **{f"{k}_expected": v for k, v in knob_want.items()},
                  memory_gather_bwd_expected=2 * memory_steps,
                  vector_gather_bwd_expected=2 * vector_steps,
                  launches=counts))
        idle = [k for k in attention.KERNELS if frozen_counts[k] == 0]
        idle += [f"{k} (memory path)" for k in MEMORY_PATH_KERNELS
                 if memory_counts[k] == 0]
        idle += [f"{k} (layer-2 path)" for k in MEMORY_PATH_KERNELS
                 if layer2_counts[k] == 0]
        # the multi-host paths that train with attention launch the
        # dropout pair (and, with a val pass, the inference forward)
        idle += [f"{k} ({path})" for path, want in mh_want.items()
                 for k in MEMORY_PATH_KERNELS
                 if want[k] and not mh_counts[path][k]]
        # the sharded paths: TGN-memory.yml at dropout 0.2 (world size 1)
        # and at dropout 0 (dp = 2: the dropout-0 pair)
        idle += [f"{k} (sharded path)" for k in MEMORY_PATH_KERNELS
                 if not sharded_counts[k]]
        idle += [f"{k} (sharded dp = 2 path)" for k in
                 ("attention_fwd", "attention_bwd", "attention_fwd_infer")
                 if not dp2_counts[k]]
        # the three knobs' paths train at dropout > 0 (remat: no val pass)
        idle += [f"{k} ({path})" for path in knob_counts
                 for k in MEMORY_PATH_KERNELS[:2 if path == "remat" else 3]
                 if not knob_counts[path][k]]
        if idle:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{idle}")
        if (layer2_counts != layer2_want or dyrep_counts != dyrep_want
                or fit_counts != fit_want or transport_counts != transport_want
                or mh_counts != mh_want or sharded_counts != sharded_serial
                or dp2_counts != dp2_want or knob_counts != knob_want
                or memory_counts["gather_bwd"] != 2 * memory_steps
                or frozen_counts["gather_bwd"]
                or any(vector_counts[k] for k in attention.KERNELS)
                or vector_counts["gather_bwd"] != 2 * vector_steps
                or any(jodie_counts.values())):
            raise AssertionError(
                f"layer-2 path launches {layer2_counts}, expected "
                f"{layer2_want}; DyRep path {dyrep_counts}, expected "
                f"{dyrep_want}; fit path {fit_counts}, expected "
                f"{fit_want}; device-side transports {transport_counts}, "
                f"expected {transport_want}; multi-host paths {mh_counts}, "
                f"expected {mh_want}; sharded paths {sharded_counts}, "
                f"{dp2_counts}, expected {sharded_serial}, {dp2_want}; "
                f"the knobs' paths {knob_counts}, expected {knob_want}; "
                f"memory path {memory_counts} ({memory_steps} steps); "
                f"frozen path {frozen_counts}; "
                f"vector path {vector_counts} ({vector_steps} steps); "
                f"JODIE path {jodie_counts}")
        phase = "profile"
        phase_profile(torch, pkg, data, cfg_path, "frozen")
        phase_profile(torch, pkg, data, mem_cfg_path, "memory")
        phase_profile(torch, pkg, data, layer2_cfg_path, "layer2",
                      protocol="column_chunk")
        phase_profile(torch, pkg, data, jodie_cfg_path, "jodie")
        phase_profile(torch, pkg, data, dyrep_cfg_path, "dyrep")
        phase_profile(torch, pkg, data, cfg_path, "device_cache",
                      protocol="column_chunk", device_cache=True)
        phase_profile(torch, pkg, data, cfg_path, "train_lean", evals=False,
                      wire_train_lean=True)
    except Exception as e:            # report the phase, then fail
        traceback.print_exc()
        emit(dict(phase=phase, ok=False, error=f"{type(e).__name__}: {e}"))
        return 1
    emit({"kernels": [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=REPLACES[name], launches=counts[name],
             max_abs_err=kres[name]["max_abs_err"], ms=kres[name]["ms"],
             plain_ms=kres[name]["plain_ms"],
             bound_ms=kres[name]["bound_ms"],
             bound_by=kres[name]["bound_by"], library_ms=None)
        for name in attention.KERNELS] + [
        dict(name="gather_bwd", route="cuda", source=GATHER_SOURCE,
             replaces=None, launches=counts["gather_bwd"],
             max_worst_row_err=kres["gather_bwd"]["max_worst_row_err"],
             ms=kres["gather_bwd"]["ms"],
             op_ms=kres["gather_bwd"]["op_ms"],
             aten_ms=kres["gather_bwd"]["aten_ms"],
             plain_ms=kres["gather_bwd"]["plain_ms"],
             bound_ms=kres["gather_bwd"]["bound_ms"],
             bound_by="bytes",
             pct_of_bound=kres["gather_bwd"]["pct_of_bound"],
             library_ms=None)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sys.exit(sharded_worker(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
