"""The readings each correctness limit is set from, for one cell, on the
card: per seed, the program's numbers against the plain reference (the
sound readings), and on the first ``--controls`` seeds the control (the
reference computed in TF32, the precision below the configuration's
float32 with TF32 off) and, for a train cell, a planted fault (the
reference's loss over half of each batch, its mean over the rest; a
step that leaves the parameters and the memory unchanged), each against
the reference in float32.

    python3 bench_cuda/control.py --workload <name> --seeds 1,2,3 \\
        --controls 3 --out control.jsonl

The benchmark's runs do not run this; ``limits/<workload>.json`` holds
the limits set from its readings.  One line of JSON per seed.  Each seed
builds the cell as a run's set-up does and makes one call of its entry
(a train cell's readings come from the set-up's first epoch).  Beside
the compared numbers it reads ones that no run compares, with which the
compared ones were chosen: the worst leaf's first gradient, each leaf's
change after the three steps (worst and median), the val pass's MRR and
rank gaps, and its answers outside the reference's bounds at each slack
of ``TAUS``.
"""
from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# the score slacks of the val pass's answers, relative to max(1, |pos|)
TAUS = (0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2)


def train_extra(prog: dict, ref, weights, leaves: dict) -> dict:
    """Each step's relative loss gap, the worst leaf's first-gradient
    gap and the worst leaf's change gap; each leaf's gaps and its
    reference gradient over the median leaf's go into ``leaves``."""
    import numpy as np
    from bench_cuda import check
    g_ref = {k: v.cpu() for k, v in ref.grads[0].items()}
    med_g = float(np.median([float(v.norm()) for v in g_ref.values()]))
    grad = check.leaf_gaps(prog["g1"], g_ref, check.counted_leaves(g_ref))
    change = check.change_gaps(prog, ref, weights)
    leaves.update(grad={k: (v, float(g_ref[k].norm()) / med_g)
                        for k, v in grad.items()}, change=change)
    out = {f"loss_gap_step{i + 1}": abs(float(p) - r) / abs(r)
           for i, (p, r) in enumerate(zip(prog["losses"], ref.losses))}
    out.update(grad_gap=max(grad.values(), default=0.0),
               change_gap=max(change.values(), default=0.0))
    return out


def val_extra(prog: dict, ref) -> dict:
    """The largest gap of a pass's MRR and of an event's rank (last
    pass) from the reference's, and per slack of the reference's bounds
    the events of the last pass outside them."""
    import numpy as np
    from bench_cuda import check
    opt, pes, _ = prog["counts"][-1]
    ranks = 0.5 * (opt + pes) + 1.0
    ref_ranks = 0.5 * ref.counts.sum(axis=1) + 1.0
    out = {"mrr_gap": max(abs(m - ref.mrr) for m in prog["mrrs"]),
           "rank_gap": float(np.abs(ranks - ref_ranks).max())}
    for tau, n in zip(ref.taus, check.rank_outside(opt, pes, ref.bounds)):
        out[f"rank_outside_tau{tau:g}"] = float(n)
    return out


def readings(run, base, prog=None, leaves=None) -> dict:
    """``run``'s compared numbers of ``prog`` (default: the program's
    readings) against the reference result ``base``, and the ones no run
    compares."""
    prog = run.readings if prog is None else prog
    out = dict(run.numbers(base, prog))
    if run.entry == "train_epoch":
        out.update(train_extra(prog, base, run.weights,
                               {} if leaves is None else leaves))
    else:
        out.update(val_extra(prog, base))
    return out


def main(argv=None) -> int:
    import argparse
    from bench_cuda import harness, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default=None,
                    help="another stream preset (a test's small size)")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload, spec.benchmark())
    seeds = [int(s) for s in args.seeds.split(",")]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            run = harness.Run(cell, seed, args.device,
                              harness.Clock(time.perf_counter()),
                              args.preset)
            if run.entry == "evaluate":
                run.window(0.0)
            run.outputs()
            base = run.reference(taus=TAUS)
            leaves: dict = {}
            line = {"workload": args.workload, "seed": seed,
                    "sound": readings(run, base, leaves=leaves)}
            if leaves:
                line["sound_leaves"] = leaves
            if i < args.controls:
                ctl = run.reference(tf32=True)
                line["control"] = readings(run, base, run.as_program(ctl))
                if run.entry == "train_epoch":
                    for fault in ("half_batch", "still"):
                        r = run.reference(**{fault: True})
                        line[fault] = readings(run, base,
                                               run.as_program(r))
            line["seconds"] = time.perf_counter() - t0
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)
            del run, base
    return 0


if __name__ == "__main__":
    sys.exit(main())
