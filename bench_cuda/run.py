"""The benchmark of tgb_tgn_dgl_tpu_torch (the PyTorch and CUDA port):
one run of one cell on the CUDA cards of this machine.

    python3 bench_cuda/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell is found by name in
``BENCHMARK.json``; its configuration, traffic, limits and per-layer
metrics in files under ``bench_cuda/`` (``bench_cuda/spec.py``).  The run
prints its set-up parts and each compared number beside its limit on
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s`` of the profiled
call), with ``--trace 1`` a ``breakdown`` of device time and idle gaps,
and last ``checks``.

It exits non-zero, with no result, when CUDA has fewer cards than the
cell asks for, or when a module of JAX or of the JAX package is loaded.
Every build and kernel cache of the program lies inside the checkout
(``tgb_tgn_dgl_tpu_torch/_build/``, ``bench_cuda/_cache/``).
"""
from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """``time.perf_counter()`` at the start of this process."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number from 0 up")

    from bench_cuda import harness, spec

    def err(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    chips = int(cell.workload["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"this cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    clock = harness.Clock(T_START)
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", clock, log=err)
    for name, sec in clock.parts.items():
        err(f"setup {name} {sec:.3f} s"
            + (" (not in setup_s)" if name in clock.uncounted else ""))
    err(f"reference {res['reference_s']:.3f} s")
    found = harness.forbidden_modules()
    if found:
        err("modules of JAX or of the JAX package are loaded: "
            + ", ".join(found))
        return 3
    line = harness.result_line(res, bool(args.trace), {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": chips})
    for name, value in res["numbers"].items():
        if name not in res["checks"]:
            err(f"reading {name} {value!r} (not compared)")
    for name, c in res["checks"].items():
        err(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
