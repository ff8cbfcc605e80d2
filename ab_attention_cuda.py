#!/usr/bin/env python3
"""A/B timing of two builds of the port's attention kernels on one GPU.

    python3 ab_attention_cuda.py --baseline OLD/attention.cu

Builds ``OLD/attention.cu`` (an earlier version of
tgb_tgn_dgl_tpu_torch/csrc/attention.cu, for example from ``git archive``
of the parent commit) with this checkout's nvcc flags, beside this
checkout's own build.  Then it times every entry point at the shape
chip_smoke.py times it at, with chip_smoke.py's inputs, calling both
libraries through ctypes with the same preallocated outputs.  Each
timing is a median of 30 launches, taken two ways:

  written_flush    chip_smoke.py's own: each launch after a 128 MB write
                   that flushes the L2 (and leaves it full of dirty
                   lines, whose write-back the timed kernel shares)
  read_flush_spin  each launch after a 128 MB read that flushes the L2,
                   then a device spin of about 1 ms, so that neither
                   write-back nor the host's enqueue time falls inside
                   the events

Each of ROUNDS rounds runs baseline, change, change, baseline under each
timing; an entry point the baseline lacks is timed on the change side
only.  Each round also times ``stream``: one torch call that reads and
writes the same large tensors with no math (el' -> a for attention_fwd,
el' summed over Kp for attention_fwd_infer, el' * dm -> a for
attention_fwd_drop, el' * a -> d_el' for attention_bwd, el' + a * dm ->
d_el' for attention_bwd_drop), what the memory system gives for those
bytes under that timing.  One JSON line per entry point and timing
with every run's median, then the nvidia-smi name and power limit.  Exits
2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import sys

import chip_smoke as cs

ORDER = ("baseline", "change", "change", "baseline")
ROUNDS = 5
SPIN_CYCLES = 2_000_000       # about 1 ms of device time


def time_ms_read_spin(torch, fn, flush) -> float:
    """Median device time of ``fn`` over cs.TIMED_RUNS launches, each after
    a read of ``flush`` and a device spin."""
    fn()
    times = []
    for _ in range(cs.TIMED_RUNS):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


TIMINGS = {"written_flush": cs.time_ms, "read_flush_spin": time_ms_read_spin}


def build_libraries(build, sources: dict) -> dict:
    """Build each ``label: path of an attention.cu`` into the git-ignored
    build directory with this checkout's nvcc flags, all at once; returns
    ``label: (ctypes.CDLL, compiler log)``."""
    outs = {label: build.BUILD / f"libattention-{label}.so"
            for label in sources}
    report = build.compile_all({label: (path, outs[label])
                                for label, path in sources.items()})
    return {label: (ctypes.CDLL(str(outs[label])), report[label]["log"])
            for label in sources}


def kernel_case(torch, attention, name):
    """chip_smoke.py's inputs for entry point ``name`` at the shape it is
    timed at: its ctypes arguments, the ``stream`` call, the shape, and the
    tensors behind the pointers (held by the caller while it times)."""
    R, Kp, H, frac = {label: rest for label, *rest in cs.SHAPES}[
        cs.TIMED_SHAPES[name][0]]
    el, er, mask, dm, grad = cs.kernel_inputs(torch, R, Kp, H, frac, seed=0)
    a = attention.attention_probs_reference(el, er, mask, cs.SLOPE)
    out, d_er = torch.empty_like(er), torch.empty_like(er)
    res, d_el = torch.empty_like(el), torch.empty_like(el)
    tensors = {
        "attention_fwd": (el, er, mask, out, res),
        "attention_fwd_infer": (el, er, mask, out),
        "attention_fwd_drop": (el, er, mask, dm, out, res),
        "attention_bwd": (el, er, mask, a, grad, d_el, d_er),
        "attention_bwd_drop": (el, er, mask, dm, a, grad, d_el, d_er),
    }[name]
    stream = torch.cuda.current_stream().cuda_stream
    argv = [t.data_ptr() for t in tensors] + [R, Kp, H, cs.SLOPE, stream]
    stream_fn = {
        "attention_fwd": lambda: res.copy_(el),
        "attention_fwd_infer": lambda: torch.sum(el, dim=1, out=out),
        "attention_fwd_drop": lambda: torch.mul(el, dm, out=res),
        "attention_bwd": lambda: torch.mul(el, a, out=d_el),
        "attention_bwd_drop": lambda: torch.addcmul(el, a, dm, out=d_el),
    }[name]
    return argv, stream_fn, (R, Kp, H), tensors


def ctypes_call(attention, lib, name, argv, label):
    """A call of ``lib``'s entry point ``name`` on ``argv`` that raises on
    a CUDA error; None when ``lib`` lacks the entry point."""
    fn = getattr(lib, name, None)
    if fn is None:
        return None
    fn.argtypes = attention._ARGTYPES[name]
    fn.restype = ctypes.c_int

    def call():
        rc = fn(*argv)
        if rc != 0:
            raise RuntimeError(f"{label} {name}: CUDA error {rc}")
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="path of the earlier attention.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_attention_cuda: no CUDA device", file=sys.stderr)
        return 2
    from tgb_tgn_dgl_tpu_torch.ops import _build, attention
    libs = {"baseline": build_libraries(_build, {"baseline": args.baseline})[
        "baseline"][0], "change": _build.library("attention")}
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    for name in attention.KERNELS:
        argv, stream_fn, (R, Kp, H), _held = kernel_case(torch, attention,
                                                         name)
        calls = {side: ctypes_call(attention, lib, name, argv, side)
                 for side, lib in libs.items()}
        calls = {side: c for side, c in calls.items() if c is not None}
        bound_ms, bound_by, nbytes = cs.kernel_bound(name, R, Kp, H)
        for timing, timer in TIMINGS.items():
            runs = {side: [] for side in [*calls, "stream"]}
            for _ in range(ROUNDS):
                for side in ORDER:
                    if side in calls:
                        runs[side].append(timer(torch, calls[side], flush))
                runs["stream"].append(timer(torch, stream_fn, flush))
            rec = dict(kernel=name, timing=timing, timed_at=[R, Kp, H],
                       bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
            for side, ms in runs.items():
                rec[f"{side}_ms"] = ms
                rec[f"{side}_median_ms"] = statistics.median(ms)
            cs.emit(rec)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
