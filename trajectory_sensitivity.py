#!/usr/bin/env python3
"""How far a last-bit difference moves a short training run of the port.

    python3 trajectory_sensitivity.py [--layers 2] [--seeds 12]
    python3 trajectory_sensitivity.py --full-width CONFIG [--epochs 2]

Runs ``chip_smoke.py``'s reference stream (the tiny synthetic stream, 6
Adam steps at lr 1e-3 and dropout 0, then the val and the test pass) with
the mailbox memory on the CPU, once as it is and then once per seed with
every attention output multiplied by (1 + u), u uniform in ±eps, the size
of the difference between an attention kernel and its plain version.
Prints one JSON line per eps: the largest |Δ mem| of the final
MemoryState and of any parameter, per seed.  This is the yardstick for
the GPU-against-CPU checks of ``chip_smoke.py`` (``memory_reference``,
``layer2_reference``): a difference the perturbed CPU runs show too is the
trajectory's own, not the kernels'.

``--full-width CONFIG`` runs ``fit`` of that config at dropout 0 on
``synthetic(--data)`` on the GPU (``--device``) instead, unperturbed and
perturbed, and prints each epoch's loss (relative) and val MRR (absolute)
difference: the yardstick for the sharded engine's epoch losses and MRRs
against the serial run (``chip_smoke.py``'s ``sharded_two_rank_train``,
``sharded_multi_gpu.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import torch

from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.models import tgnn
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config, parse_config_dict

RAW = dict(sampling=[dict(neighbor=[5])],
           gnn=[dict(att_head=4, dim_out=32, dim_time=32)],
           memory=[dict(dim_out=32, dim_time=32)],
           train=[dict(batch_size=100, lr=1e-3, dropout=0.0, att_dropout=0.0,
                       eval_neg_chunk=3, frozen_memory=False)])


@contextlib.contextmanager
def perturbed_attention(eps: float, seed: int):
    """Every attention output multiplied by (1 + u), u uniform in ±eps
    (drawn on the host from ``seed``), while inside."""
    core = tgnn.attention_core
    gen = torch.Generator().manual_seed(seed)

    def perturbed(el, er, mask, slope, drop_mask=None):
        out = core(el, er, mask, slope, drop_mask=drop_mask)
        u = torch.rand(out.shape, generator=gen).to(out.device) * 2 - 1
        return out * (1 + eps * u)

    tgnn.attention_core = perturbed
    try:
        yield
    finally:
        tgnn.attention_core = core


def run(layers: int, eps: float, seed: int):
    """(final mem, parameters) of one run with the attention outputs
    perturbed by ``eps`` (0: unperturbed)."""
    with perturbed_attention(eps, seed):
        raw = dict(RAW, gnn=[dict(RAW["gnn"][0], layer=layers)])
        data = synthetic("tiny", num_edges=855, num_nodes=120, msg_dim=8,
                         num_neg=8, seed=1)
        eng = Engine(data, parse_config_dict(raw), device="cpu")
        eng.train_epoch()
        eng.evaluate("val")
        eng.evaluate("test")
    return eng.mem_state.mem.clone(), {
        n: p.detach().clone() for n, p in eng.model.named_parameters()}


def run_full_width(config: str, data_name: str, epochs: int, eps: float,
                   seed: int, device):
    """Each epoch's (loss, val MRR) of ``fit`` at dropout 0, the attention
    outputs perturbed by ``eps`` (0: unperturbed)."""
    cfg = parse_config(config)
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(
        cfg.gnn, override_dropout=0.0))
    eng = Engine(synthetic(data_name), cfg, device=device)
    with (perturbed_attention(eps, seed) if eps
          else contextlib.nullcontext()):
        hist = eng.fit(epochs=epochs, log=lambda msg: None)
    return hist["loss"], hist["val"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-6])
    ap.add_argument("--full-width", metavar="CONFIG", default=None)
    ap.add_argument("--data", default="tgbl-wiki")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="--full-width: torch device (default: the GPU)")
    args = ap.parse_args()
    if args.full_width:
        loss0, val0 = run_full_width(args.full_width, args.data, args.epochs,
                                     0.0, 0, args.device)
        print(json.dumps(dict(config=args.full_width, eps=0.0, loss=loss0,
                              val=val0)), flush=True)
        for eps in args.eps:
            for seed in range(args.seeds):
                loss, val = run_full_width(args.full_width, args.data,
                                           args.epochs, eps, seed,
                                           args.device)
                print(json.dumps(dict(
                    config=args.full_width, eps=eps, seed=seed, loss=loss,
                    val=val,
                    loss_rel_diff=[abs(a - b) / abs(b)
                                   for a, b in zip(loss, loss0)],
                    val_abs_diff=[abs(a - b) for a, b in zip(val, val0)])),
                    flush=True)
        return
    mem0, params0 = run(args.layers, 0.0, 0)
    for eps in args.eps:
        mem, par = [], []
        for seed in range(args.seeds):
            m, p = run(args.layers, eps, seed)
            mem.append(float((m - mem0).abs().max()))
            par.append(max(float((p[n] - params0[n]).abs().max())
                           for n in p))
        print(json.dumps(dict(layers=args.layers, eps=eps,
                              max_mem_diff=mem, max_param_diff=par)),
              flush=True)


if __name__ == "__main__":
    main()
