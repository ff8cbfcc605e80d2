#!/usr/bin/env python3
"""The sharded engine across GPUs, every arm at dropout 0: two epochs of a
config through the port's CLI on one GPU (the serial Engine) and with
``--engine sharded`` over the processes of ``torch.distributed.run``
(NCCL, one GPU a process) at each (dp, state) layout asked for; one JSON
line a run from its ``metrics.jsonl`` (the times of epoch 2 and its val
pass: epoch 1 pays the kernels' build and the communicators' set-up), and
the comparison with the serial run.  Then, at each layout, every rank
trains the serial Engine and the ShardedEngine for an epoch on its own
GPU and holds the sharded engine's first-step gradients (after the sum
over dp: NCCL's all-reduce, and its reduce-scatter in the table's
backward) to the serial ones.

    python3 sharded_multi_gpu.py --layouts 1x4,2x2,4x1

A layout at dp = 1 must equal the serial run; at dp > 1 the losses and
val MRRs must be within chip_smoke.py's TWO_RANK_BOUND of it, and the
first-step gradients within its GRAD_RTOL on every rank.  Exits 1 when a
run fails or a check misses.  ``--device cpu`` runs every arm on the CPU
over gloo (a rehearsal at a small ``--data``).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from chip_smoke import (GRAD_RTOL, TWO_RANK_BOUND,  # noqa: E402
                        first_step_grads, grad_gap)


def _run(cmd, log_dir, timeout):
    """One CLI run: both epochs' losses and val MRRs, epoch 2's times."""
    out = subprocess.run(cmd + ["--log-dir", log_dir], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode:
        print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
        raise RuntimeError(f"{' '.join(cmd)} exited {out.returncode}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    train = [e for e in events if e["event"] == "train_epoch"]
    val = [e for e in events if e["event"] == "val"]
    return dict(loss=[e["loss"] for e in train],
                val=[e["value"] for e in val], train_s=train[-1]["seconds"],
                edges_per_s=train[-1]["events_per_s"],
                val_s=val[-1]["seconds"])


def _dropout_zero(config, tmp):
    """A copy of ``config`` with its train dropouts set to 0."""
    with open(config) as f:
        text = f.read()
    text, n = re.subn(r"^(\s*(?:att_)?dropout:)\s*\S+", r"\1 0.0", text,
                      flags=re.M)
    if n != 2:
        raise ValueError(f"{config}: expected dropout and att_dropout")
    path = os.path.join(tmp, "dropout0.yml")
    with open(path, "w") as f:
        f.write(text)
    return path


def grad_worker(data_name, config, dp, state, device, out_dir) -> int:
    """One rank under torch.distributed.run: the serial Engine's and the
    ShardedEngine's first-step gradients on this rank's device; writes
    the gap to ``out_dir``."""
    import torch

    from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
    from tgb_tgn_dgl_tpu_torch.engine.train import Engine
    from tgb_tgn_dgl_tpu_torch.parallel.engine import ShardedEngine
    from tgb_tgn_dgl_tpu_torch.parallel.mesh import make_mesh
    from tgb_tgn_dgl_tpu_torch.parallel.multihost import init_distributed
    from tgb_tgn_dgl_tpu_torch.run_tgn import rank_device
    from tgb_tgn_dgl_tpu_torch.utils.config import parse_config
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    backend = "gloo" if device == "cpu" else "nccl"
    if backend == "nccl":
        device = rank_device(None, world, int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    init_distributed("env://", world, rank, backend)
    try:
        data, cfg = synthetic(data_name), parse_config(config)
        grads = {}
        for name, make in (
                ("serial", lambda: Engine(data, cfg, device=device)),
                ("sharded", lambda: ShardedEngine(
                    data, cfg, mesh=make_mesh(dp=dp, state=state,
                                              backend=backend),
                    device=device))):
            eng = make()
            eng.warm_buckets()
            eng._warmed = True
            grads[name] = first_step_grads(eng)
            eng.train_epoch()
            del eng
        gap = grad_gap(grads["sharded"], grads["serial"])
        with open(os.path.join(out_dir, f"grad{rank}.json"), "w") as f:
            json.dump(dict(rank=rank, device=device, grad_gap=gap), f)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layouts", default="1x4,2x2,4x1",
                    help="comma-separated DPxSTATE mesh layouts")
    ap.add_argument("--data", default="tgbl-wiki")
    ap.add_argument("--config", default=os.path.join(
        ROOT, "tgb_tgn_dgl_tpu_torch", "configs", "TGN-memory.yml"))
    ap.add_argument("--device", default=None,
                    help="'cpu' for a gloo rehearsal; default the GPUs")
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--grad-worker", nargs=3, default=None,
                    metavar=("DP", "STATE", "OUT_DIR"),
                    help="(internal) one rank of the gradient check")
    args = ap.parse_args()
    if args.grad_worker:
        dp, state, out_dir = args.grad_worker
        return grad_worker(args.data, args.config, int(dp), int(state),
                           args.device, out_dir)
    ok = True
    with tempfile.TemporaryDirectory(prefix="sharded_multi_gpu_") as tmp:
        config = _dropout_zero(args.config, tmp)
        cli = ["-m", "tgb_tgn_dgl_tpu_torch.run_tgn", "--data", args.data,
               "--synthetic", "--config", config, "--epochs", "2"]
        dev = ["--device", args.device] if args.device else []
        serial = _run([sys.executable] + cli + dev,
                      os.path.join(tmp, "serial"), args.timeout)
        print(json.dumps(dict(run="serial", dropout=0.0, **serial)),
              flush=True)
        for layout in args.layouts.split(","):
            dp, state = (int(x) for x in layout.split("x"))
            launch = [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc-per-node", str(dp * state)]
            rec = _run(launch + cli + dev + [
                "--engine", "sharded", "--dp", str(dp), "--state-ax",
                str(state)], os.path.join(tmp, layout), args.timeout)
            loss_rel = [abs(a - b) / abs(b)
                        for a, b in zip(rec["loss"], serial["loss"])]
            val_abs = [abs(a - b) for a, b in zip(rec["val"], serial["val"])]
            out_dir = os.path.join(tmp, f"grad_{layout}")
            os.makedirs(out_dir)
            subprocess.run(launch + [os.path.abspath(__file__), "--data",
                                     args.data, "--config", config, *dev,
                                     "--grad-worker", str(dp), str(state),
                                     out_dir],
                           cwd=ROOT, check=True, timeout=args.timeout)
            gaps = []
            for r in range(dp * state):
                with open(os.path.join(out_dir, f"grad{r}.json")) as f:
                    gaps.append(json.load(f)["grad_gap"])
            equal = (rec["loss"], rec["val"]) == (serial["loss"],
                                                 serial["val"])
            within = (max(loss_rel) <= TWO_RANK_BOUND["loss_rel"]
                      and max(val_abs) <= TWO_RANK_BOUND["mrr_abs"]
                      and max(gaps) <= GRAD_RTOL)
            passed = equal if dp == 1 else within
            print(json.dumps(dict(
                run="sharded", dp=dp, state=state, dropout=0.0,
                equal_to_serial=equal, **rec, loss_rel_diff=loss_rel,
                val_abs_diff=val_abs, first_step_grad_gap=gaps,
                bound=TWO_RANK_BOUND, grad_rtol=GRAD_RTOL, passed=passed,
                train_s_over_serial=rec["train_s"] / serial["train_s"],
                val_s_over_serial=rec["val_s"] / serial["val_s"])),
                flush=True)
            ok = ok and passed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
