"""The port's command-line entry point, the counterpart of the
repository's run_tgn.py (reference pyg-mem-tgn.py:28-67):

  python -m tgb_tgn_dgl_tpu_torch.run_tgn --data tgbl-wiki --synthetic \\
      --config tgb_tgn_dgl_tpu_torch/configs/TGN-memory.yml --epochs 3 \\
      --log-dir runs/x --checkpoint-every 1 --patience 5 --val-snapshot \\
      --run-test

It runs on the GPU; ``--device cpu`` (the plain torch versions of the
kernels) is the only way onto the CPU, and without a GPU and without it
the Engine raises.  The flags are run_tgn.py's, with ``--platform``
replaced by ``--device``.  Two of run_tgn.py's faults are not copied:
``--resume`` from a checkpoint with no epoch left trains none (run_tgn.py
passes ``epochs=0``, which the JAX ``fit`` reads as the config's count),
and ``--profile`` traces epoch 1 with the same ``fit`` arguments as the
other epochs (run_tgn.py runs it without checkpoints, the val snapshot
or early stopping).  ``--engine multihost --hosts N --exchange
replicated|owned`` trains through parallel/mh_engine.py's
``MultiHostEngine`` on the one device.  ``--engine sharded --dp D
--state-ax S`` trains through parallel/engine.py's ``ShardedEngine`` over
the processes of a launch (``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``
from ``torchrun``'s environment, or one process):

  python -m torch.distributed.run --nproc-per-node 2 \
      -m tgb_tgn_dgl_tpu_torch.run_tgn --engine sharded --dp 2 ...

with gloo under ``--device cpu`` and NCCL on ``cuda:LOCAL_RANK``
otherwise (a ``--device`` naming one card for several ranks raises); rank
0 alone prints and writes the logs.  ``--eval-every N``, which run_tgn.py
lacks, runs the val pass after every N-th epoch alone.  When the named
dataset is not under ``--root``, a deterministic synthetic stream with its
scale statistics stands in (a note on stderr says so).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m tgb_tgn_dgl_tpu_torch"
                                          ".run_tgn")
    parser.add_argument("--data", type=str, required=True,
                        help="dataset name (e.g. tgbl-wiki)")
    parser.add_argument("--config", type=str,
                        default="tgb_tgn_dgl_tpu_torch/configs/TGN.yml",
                        help="path to TGL-schema config file")
    parser.add_argument("--root", type=str, default="datasets",
                        help="dataset root directory")
    parser.add_argument("--synthetic", action="store_true",
                        help="use a synthetic stream with the named "
                             "dataset's scale statistics")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override train.epoch")
    parser.add_argument("--run-test", action="store_true",
                        help="evaluate on the test split after training")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the GPU; 'cpu' runs "
                             "the plain torch versions of the kernels)")
    parser.add_argument("--log-dir", type=str, default=None,
                        help="write jsonl metrics (and checkpoints with "
                             "--checkpoint-every) under this directory")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="save a full-state checkpoint every N epochs")
    parser.add_argument("--val-snapshot", action="store_true",
                        help="snapshot/restore streaming state around "
                             "each validation pass (the reference's "
                             "unwired backup_memory intent, "
                             "model_utils.py:290-308)")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume deterministically from a full-state "
                             "checkpoint (written by --checkpoint-every); "
                             "trains the remaining epochs up to --epochs")
    parser.add_argument("--patience", type=int, default=0,
                        help="early-stop after N non-improving validations "
                             "(0 = off)")
    parser.add_argument("--eval-every", type=int, default=1,
                        help="run the val pass after every N-th epoch")
    parser.add_argument("--profile", action="store_true",
                        help="capture a torch.profiler trace of the first "
                             "epoch trained into <log-dir>/profile")
    parser.add_argument("--engine", type=str, default="single",
                        choices=("single", "sharded", "multihost"),
                        help="single: one-device Engine; sharded: the "
                             "(dp, state) mesh over the launch's processes "
                             "(parallel/engine.py); multihost: composed "
                             "super-batch engine (parallel/mh_engine.py) on "
                             "the one device")
    parser.add_argument("--dp", type=int, default=None,
                        help="sharded: data-parallel mesh width (default: "
                             "the world size over --state-ax)")
    parser.add_argument("--state-ax", type=int, default=None,
                        help="sharded: state-sharding mesh width")
    parser.add_argument("--hosts", type=int, default=2,
                        help="multihost: number of host ranges per "
                             "super-batch")
    parser.add_argument("--exchange", type=str, default="replicated",
                        choices=("replicated", "owned"),
                        help="multihost state maintenance: replicated "
                             "(every host replays all events) or owned "
                             "(node-range owners + boundary gathers)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None).  Returns the
    engine, the ``fit`` histories, the test metric (None without
    ``--run-test``) and the checkpoint's load seconds (None without
    ``--resume``)."""
    args = parse_args(argv)
    if args.engine != "sharded":
        return _run(args)
    from .parallel.multihost import init_distributed
    world = int(os.environ.get("WORLD_SIZE", 1))
    rank = int(os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", 0))
    backend = "gloo" if args.device == "cpu" else "nccl"
    import torch
    if backend == "nccl" and torch.cuda.is_available():
        # one card a process; without one the Engine raises, as the
        # serial one does
        args.device = rank_device(args.device, world, local)
        torch.cuda.set_device(args.device)
    init_distributed("env://", world, rank, backend)
    try:
        with open(os.devnull, "w") as devnull, (
                contextlib.redirect_stdout(devnull) if rank
                else contextlib.nullcontext()):
            return _run(args, backend, rank)
    finally:
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def rank_device(device: Optional[str], world: int, local: int) -> str:
    """The card of the process with local rank ``local`` under NCCL: a bare
    ``cuda`` (or none) is ``cuda:local``; a card named for a world of more
    than one process raises ValueError unless it is that one (NCCL refuses
    two ranks on one card)."""
    import torch
    dev = torch.device(device or "cuda")
    if dev.index is None:
        return f"cuda:{local}"
    if world > 1 and dev.index != local:
        raise ValueError(f"--device {device} would put several ranks on one "
                         f"card (NCCL refuses that); give --device cuda: "
                         f"each rank takes cuda:LOCAL_RANK")
    return str(dev)


def _run(args, backend: Optional[str] = None,
         rank: int = 0) -> Dict[str, object]:
    from .data.dataset import load_tgb, synthetic
    from .engine.checkpoint import EarlyStopMonitor
    from .engine.train import Engine
    from .utils.config import parse_config
    from .utils.metrics import profile

    config = parse_config(args.config)
    if args.synthetic:
        data = synthetic(args.data)
    else:
        try:
            data = load_tgb(args.data, root=args.root)
        except FileNotFoundError as e:
            print(f"{e}\nFalling back to synthetic stream.", file=sys.stderr)
            data = synthetic(args.data)

    print(f"dataset: {data.name}  events={data.num_edges}  "
          f"nodes={data.num_nodes}  msg_dim={data.msg_dim}")
    if args.engine == "sharded":
        from .parallel.engine import ShardedEngine
        from .parallel.mesh import make_mesh
        mesh = make_mesh(dp=args.dp, state=args.state_ax, backend=backend)
        print(f"engine: sharded over mesh {mesh.shape} ({backend})")
        engine = ShardedEngine(data, config, mesh=mesh, device=args.device)
    elif args.engine == "multihost":
        from .parallel.mh_engine import MultiHostEngine
        print(f"engine: multihost composed super-batches, "
              f"hosts={args.hosts}, exchange={args.exchange}")
        engine = MultiHostEngine(data, config, n_hosts=args.hosts,
                                 exchange=args.exchange, device=args.device)
    else:
        engine = Engine(data, config, device=args.device)
    epochs = args.epochs if args.epochs is not None else config.train.epoch
    load_s = None
    if args.resume:
        t0 = time.time()
        engine.load_checkpoint(args.resume)
        load_s = time.time() - t0
        print(f"resumed from {args.resume} at epoch {engine._epoch}")
        epochs = max(0, epochs - engine._epoch)
    early = None
    if args.patience:
        early = EarlyStopMonitor(max_round=args.patience,
                                 save_dir=args.log_dir)
    kw = dict(eval_every=args.eval_every, early_stop=early,
              checkpoint_dir=args.log_dir,
              checkpoint_every=args.checkpoint_every, log_dir=args.log_dir,
              val_snapshot=args.val_snapshot)
    start = time.time()
    histories = []
    if args.profile and args.log_dir and epochs > 0:
        # one trace: another rank of a sharded run trains unprofiled
        with (profile(f"{args.log_dir}/profile", device=engine.device)
              if rank == 0 else contextlib.nullcontext()):
            histories.append(engine.fit(epochs=1, **kw))
        # the monitor's first validation is always an improvement, so
        # nothing has stopped yet
        if epochs > 1:
            histories.append(engine.fit(epochs=epochs - 1, **kw))
    else:
        histories.append(engine.fit(epochs=epochs, **kw))
    test_metric = None
    if args.run_test:
        t0 = time.time()
        test_metric = engine.evaluate("test")
        print(f"Test {data.eval_metric}: {test_metric: .4f}, "
              f"elapsed Time (s): {time.time() - t0: .4f}")
    print(f"Total Execution Time: {time.time() - start:.6f} seconds")
    return dict(engine=engine, histories=histories, test=test_metric,
                load_s=load_s)


if __name__ == "__main__":
    main()
