#!/usr/bin/env python3
"""Sweep of the floats a lane holds in the backward attention kernels
(``bwd_lane_floats`` in tgb_tgn_dgl_tpu_torch/csrc/attention.cu) on one GPU.

    python3 sweep_attention_bwd.py [--values 12,16,24,32,48]

For each value, builds a copy of this checkout's attention.cu in which the
plain and the drop backward both hold that many floats of each tensor a
lane, with this checkout's nvcc flags (all copies at once, into the
git-ignored build directory), and prints one JSON line with the ptxas
registers and spills of each of its backward kernels.  Then it times
attention_bwd and attention_bwd_drop of every copy at chip_smoke.py's
train shape through ctypes, ab_attention_cuda.ROUNDS rounds with the copies
in turn (in order, then reversed), under both timings of
ab_attention_cuda.py.  One JSON line per kernel and timing with every
run's median per value, then the nvidia-smi name and power limit.  Exits 2
without a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import statistics
import sys

import ab_attention_cuda as ab
import chip_smoke as cs

KERNELS = ("attention_bwd", "attention_bwd_drop")
PATTERN = re.compile(r"(constexpr int bwd_lane_floats\(bool drop\) \{\s*"
                     r"return )drop \? \d+ : \d+;")


def variant(src: str, floats: int) -> str:
    """``src`` with bwd_lane_floats set to ``floats`` with and without dm."""
    out, n = PATTERN.subn(rf"\g<1>drop ? {floats} : {floats};", src)
    if n != 1:
        raise RuntimeError("bwd_lane_floats not found in attention.cu")
    return out


def bwd_ptxas(log: str) -> dict:
    """ptxas's register and spill lines for each backward kernel of an
    ``nvcc -Xptxas=-v`` log, keyed by its template arguments."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"attention_bwd_kernelILi(\d)ELb(\d)", line)
            key = m and f"V={m[1]}{' drop' if m[2] == '1' else ''}"
        elif key and ("registers" in line or "spill" in line):
            out.setdefault(key, []).append(line.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--values", default="12,16,24,32,48",
                    help="floats a lane per tensor, comma-separated")
    args = ap.parse_args()
    values = [int(v) for v in args.values.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("sweep_attention_bwd: no CUDA device", file=sys.stderr)
        return 2
    from tgb_tgn_dgl_tpu_torch.ops import _build, attention
    src = (_build.CSRC / "attention.cu").read_text()
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    paths = {}
    for v in values:
        paths[f"bwd{v}"] = _build.BUILD / f"attention-bwd{v}.cu"
        paths[f"bwd{v}"].write_text(variant(src, v))
    libs = ab.build_libraries(_build, paths)
    for label, (_, log) in libs.items():
        cs.emit(dict(floats=int(label[3:]), ptxas=bwd_ptxas(log)))
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    order = list(libs) + list(libs)[::-1]
    for name in KERNELS:
        argv, _, (R, Kp, H), _held = ab.kernel_case(torch, attention, name)
        calls = {label: ab.ctypes_call(attention, lib, name, argv, label)
                 for label, (lib, _) in libs.items()}
        bound_ms, bound_by, _ = cs.kernel_bound(name, R, Kp, H)
        for timing, timer in ab.TIMINGS.items():
            runs = {label: [] for label in calls}
            for _ in range(ab.ROUNDS):
                for label in order:
                    runs[label].append(timer(torch, calls[label], flush))
            cs.emit(dict(kernel=name, timing=timing, timed_at=[R, Kp, H],
                         bound_ms=bound_ms, bound_by=bound_by,
                         median_ms={int(k[3:]): statistics.median(v)
                                    for k, v in runs.items()},
                         runs_ms={int(k[3:]): v for k, v in runs.items()}))
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
