"""The traced sub-window: ``torch.profiler`` over one call of the cell's
entry (one train epoch, one val pass); ``profile`` hands back its chrome
trace's events, and ``read_events`` reads them:

* ``window_s``: the length of the ``bench.window`` annotation around the
  call (the call ends on its metrics fetch, so the device is done);
* ``busy_s``: the union of the device's kernel, copy and set intervals
  inside it;
* ``kernels``: device seconds by kernel name, ``kernel_counts`` the
  launches of each in the trace;
* ``idle_gaps``: each stretch inside the window with nothing on the
  device, by the innermost host op or runtime call running at its start.

The program's spans in the same events are ``spans.read_spans``'s to
read.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


def profile(torch, fn: Callable[[], object]) -> List[dict]:
    """Run ``fn`` once under the profiler, inside a ``bench.window``
    annotation; return the chrome trace's events."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from torch.profiler import record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with prof_ctx(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _merge(intervals: List[Tuple[float, float]]):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_events(events: List[dict]) -> dict:
    """The reading of a chrome trace's events (times in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW]
    if not win:
        raise RuntimeError("the trace has no bench.window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                         w1), e)
           for e in spans if e.get("cat") in DEVICE_CATS]
    dev = [(a, b, e) for a, b, e in dev if b > a]
    kernels: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for a, b, e in dev:
        kernels[e.get("name", "?")] += (b - a) * 1e-6
        counts[e.get("name", "?")] += 1
    busy = _merge([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "?")) for e in spans
                   if e.get("cat") in HOST_CATS), key=lambda x: x[0])
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    # the innermost host op covering a gap's start is the latest started
    # one still running: gap starts only grow, so an op that has ended
    # before one gap has ended before every later one
    active: list = []
    j = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        while j < len(host) and host[j][0] <= g0:
            heapq.heappush(active, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while active and active[0][1] <= g0:
            heapq.heappop(active)
        gaps[active[0][2] if active else "host"] += (g1 - g0) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": dict(kernels), "kernel_counts": dict(counts),
            "idle_gaps": dict(gaps)}


def top(d: Dict[str, float], n: int = 10, width: int = 96):
    """The ``n`` largest entries of ``d`` as [name, seconds] pairs."""
    return [[k[:width], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
