#!/usr/bin/env python3
"""How far a last-bit difference moves a short training run of the port.

    python3 trajectory_sensitivity.py [--layers 2] [--seeds 12]

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
"""
from __future__ import annotations

import argparse
import json

import torch

from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.models import tgnn
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

RAW = dict(sampling=[dict(neighbor=[5])],
           gnn=[dict(att_head=4, dim_out=32, dim_time=32)],
           memory=[dict(dim_out=32, dim_time=32)],
           train=[dict(batch_size=100, lr=1e-3, dropout=0.0, att_dropout=0.0,
                       eval_neg_chunk=3, frozen_memory=False)])


def run(layers: int, eps: float, seed: int):
    """(final mem, parameters) of one run with the attention outputs
    perturbed by ``eps`` (0: unperturbed)."""
    core = tgnn.attention_core
    gen = torch.Generator().manual_seed(seed)

    def perturbed(el, er, mask, slope, drop_mask=None):
        out = core(el, er, mask, slope, drop_mask=drop_mask)
        u = torch.rand(out.shape, generator=gen) * 2 - 1
        return out * (1 + eps * u)

    tgnn.attention_core = perturbed
    try:
        raw = dict(RAW, gnn=[dict(RAW["gnn"][0], layer=layers)])
        data = synthetic("tiny", num_edges=855, num_nodes=120, msg_dim=8,
                         num_neg=8, seed=1)
        eng = Engine(data, parse_config_dict(raw), device="cpu")
        eng.train_epoch()
        eng.evaluate("val")
        eng.evaluate("test")
    finally:
        tgnn.attention_core = core
    return eng.mem_state.mem.clone(), {
        n: p.detach().clone() for n, p in eng.model.named_parameters()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-6])
    args = ap.parse_args()
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
