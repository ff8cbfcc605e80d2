"""The program's spans in a device trace: which part of the program
launched each kernel, copy and set, which part the main thread was in
while the device sat idle, and how many launches each part made.

The program names the parts of its step with spans
(``tgb_tgn_dgl_tpu_torch/utils/metrics.py``), each a ``user_annotation``
region of the trace while torch.profiler records: ``feed`` (with
``feed.fetch`` and ``feed.copy``) and ``step`` (with ``step.expand``,
``step.memory.apply``, ``step.embed``, ``step.backward``,
``step.memory.commit``, ``step.adam``, ``step.stats``, ``step.score`` and
``step.advance``).  The main thread is the one that holds the
``bench.window`` annotation.  ``read_spans`` gives:

* ``span_device_s``: per span, the device seconds inside the window of
  what it launched (``fwd``) and of the backward of the forward ops it
  ran (``bwd``).  Each kernel, copy and set goes to the runtime call that
  launched it (the trace's ``correlation`` id).  A call on the main thread
  goes to the innermost span holding it.  A call inside a backward node
  (``autograd::engine::evaluate_function: ...``, on the autograd device
  thread on CUDA) goes to the span that held the forward op of the same
  ``Sequence number`` on the main thread (the last op to start with it:
  the ops before the one that made the node carry its number too); a
  call on another thread and in no such node, to the main thread's
  innermost span at its time.  What has no owner is ``outside``.  None
  when no op carries a sequence number;
* ``span_kernels``: the same seconds by ``<span>:<fwd|bwd>`` and kernel;
* ``span_idle_s``: the idle gaps of ``trace.read_events`` (the same gaps
  as ``idle_gaps``), each moment of a gap put down to the innermost
  main-thread span running then, or ``outside``: a gap that opens just
  before a span and runs through it is that span's;
* ``span_launches``: per span and share, the runtime calls that enqueue
  device work (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
  ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``);
* ``steps``: the ``step`` spans in the window.

It returns None for a trace with no span on the main thread or no
correlation id on its device events.  ``layer_metrics`` turns a reading
into per-step and per-window numbers; the harness reads the events of
its profiled call with it and hands ``layer_metrics`` of the reading to
every per-layer metric's reader as ``ctx["span_metrics"]``.

    python3 bench_cuda/spans.py --workload <name> --seed <n> \\
        [--seconds <s>] [--calls <k>]

from the root of a checkout sets the cell up as ``run.py`` does, runs
``--seconds`` of its entry untraced, and prints for each of ``--calls``
profiled calls one JSON line: ``trace.read_events``'s window, busy and
idle numbers, ``layer_metrics``, the reading, and the program's own host
spans of the call.  It needs a CUDA card.
"""
from __future__ import annotations

import heapq
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from bench_cuda import trace  # noqa: E402

ROOTS = ("feed", "step")
OUTSIDE = "outside"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
LAUNCH_NAMES = ("cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
BACKWARD_NODE = "autograd::engine::evaluate_function"
MEMORY_SPANS = ("step.memory.apply", "step.memory.commit")


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES) or name in LAUNCH_NAMES


def under(name: str, root: str) -> bool:
    """Whether span ``name`` is ``root`` or one of its children."""
    return name == root or name.startswith(root + ".")


def _innermost(spans: List[Tuple[float, float, object]],
               times: List[float]) -> list:
    """For each of ``times``, the label of the innermost of the nested
    ``spans`` ((start, end, label)) running at it, else None: the one
    started last among those not yet ended (on equal starts, the one that
    ends first)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: list = [None] * len(times)
    active: list = []
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            heapq.heappush(active, (-spans[j][0], spans[j][1], j))
            j += 1
        while active and active[0][1] <= t:
            heapq.heappop(active)
        if active:
            out[i] = spans[active[0][2]][2]
    return out


def _iv(e: dict) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def read_spans(events: List[dict]) -> Optional[dict]:
    """The spans' reading of a chrome trace's events (module docstring)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == trace.WINDOW]
    if not win:
        raise RuntimeError("the trace has no bench.window annotation")
    w0, w1 = _iv(win[0])
    main = (win[0].get("pid"), win[0].get("tid"))

    def thread(e):
        return e.get("pid"), e.get("tid")

    spans = [(*_iv(e), e["name"]) for e in xs
             if e.get("cat") == "user_annotation" and thread(e) == main
             and e["name"].split(".")[0] in ROOTS]
    dev = [(max(a, w0), min(b, w1), e) for a, b, e in
           ((*_iv(e), e) for e in xs if e.get("cat") in trace.DEVICE_CATS)]
    dev = [(a, b, e) for a, b, e in dev if b > a]
    if not spans or not any("correlation" in e.get("args", {})
                            for _, _, e in dev):
        return None

    # the span of each forward op's sequence number, on the main thread.
    # An op records the number the next autograd node will take, so the
    # ops before the one that makes that node carry it too: the last op
    # to start with a number is the node's (or inside it)
    ops = [e for e in xs if e.get("cat") == "cpu_op"]
    fwd_ops = sorted((e for e in ops if thread(e) == main
                      and "Sequence number" in e.get("args", {})
                      and not e["args"].get("Fwd thread id")),
                     key=lambda e: float(e["ts"]))
    fwd_span: Dict[int, Optional[str]] = {}
    for e, name in zip(fwd_ops, _innermost(spans, [float(e["ts"])
                                                   for e in fwd_ops])):
        fwd_span[e["args"]["Sequence number"]] = name
    nodes = defaultdict(list)       # backward nodes by thread
    for e in ops:
        a = e.get("args", {})
        if (e["name"].startswith(BACKWARD_NODE) and a.get("Fwd thread id")
                and "Sequence number" in a):
            nodes[thread(e)].append((*_iv(e), a["Sequence number"]))

    # the owner (span, share) of each runtime call
    calls = [e for e in xs if e.get("cat") in RUNTIME_CATS
             and "correlation" in e.get("args", {})]
    at_main = _innermost(spans, [float(e["ts"]) for e in calls])
    by_thread = defaultdict(list)
    for i, e in enumerate(calls):
        by_thread[thread(e)].append(i)
    seq: list = [None] * len(calls)
    for th, idx in by_thread.items():
        for i, s in zip(idx, _innermost(nodes.get(th, []),
                                        [float(calls[i]["ts"])
                                         for i in idx])):
            seq[i] = s
    owner: Dict[object, Tuple[str, str]] = {}
    launches: Dict[str, Dict[str, int]] = defaultdict(
        lambda: {"fwd": 0, "bwd": 0})
    for e, s, m in zip(calls, seq, at_main):
        if s is not None and s in fwd_span:
            own = (fwd_span[s] or OUTSIDE, "bwd")
        else:
            own = (m or OUTSIDE, "fwd")
        owner[e["args"]["correlation"]] = own
        if is_launch(e.get("name", "")) and w0 <= float(e["ts"]) < w1:
            launches[own[0]][own[1]] += 1

    device: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"fwd": 0.0, "bwd": 0.0})
    kernels: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for a, b, e in dev:
        name, share = owner.get(e.get("args", {}).get("correlation"),
                                (OUTSIDE, "fwd"))
        device[name][share] += (b - a) * 1e-6
        kernels[f"{name}:{share}"][e.get("name", "?")] += (b - a) * 1e-6

    busy = trace._merge([(a, b) for a, b, _ in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    # the window cut at every span boundary, each piece with its span
    cuts = sorted({w0, w1, *(x for a, b, _ in spans for x in (a, b)
                             if w0 < x < w1)})
    pieces = list(zip(cuts[:-1], cuts[1:], _innermost(spans, cuts[:-1])))
    idle: Dict[str, float] = defaultdict(float)
    i = 0
    for g0, g1 in gaps:
        while pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            idle[name or OUTSIDE] += (min(b, g1) - max(a, g0)) * 1e-6
            j += 1

    has_seq = bool(fwd_span) or bool(nodes)
    return {"span_device_s": dict(device) if has_seq else None,
            "span_kernels": {k: dict(v) for k, v in kernels.items()},
            "span_idle_s": dict(idle), "span_launches": dict(launches),
            "steps": sum(1 for a, _, name in spans
                         if name == "step" and w0 <= a < w1)}


def layer_metrics(reading: Optional[dict], base: dict) -> Dict[str, float]:
    """Per-step and per-window numbers of ``reading`` in the window of
    ``base`` (``trace.read_events``'s reading of the same trace):
    ``memory_device_ms`` (device ms a step under ``step.memory.apply`` and
    ``step.memory.commit``, forward and backward), ``idle_in_step_pct``,
    ``idle_in_feed_pct`` and ``idle_outside_pct`` (the window's share idle
    with the main thread in that span, its children included, or in
    none), ``launches_per_step`` (launches under ``step``) and
    ``outside_busy_pct`` (device seconds owned by no span over
    ``busy_s``).  Empty where the reading is None."""
    if reading is None:
        return {}
    win = base["window_s"]
    idle = reading["span_idle_s"]
    out = {f"idle_in_{root}_pct": 100.0 * sum(
        v for k, v in idle.items() if under(k, root)) / win
        for root in ROOTS}
    out["idle_outside_pct"] = 100.0 * idle.get(OUTSIDE, 0.0) / win
    steps = reading["steps"]
    if steps:
        out["launches_per_step"] = sum(
            sum(v.values()) for k, v in reading["span_launches"].items()
            if under(k, "step")) / steps
    dev = reading["span_device_s"]
    if dev is not None:
        if steps:
            out["memory_device_ms"] = 1e3 * sum(
                sum(dev.get(k, {}).values()) for k in MEMORY_SPANS) / steps
        if base["busy_s"] > 0.0:
            outside = sum(dev.get(OUTSIDE, {}).values())
            out["outside_busy_pct"] = 100.0 * outside / base["busy_s"]
    return out


def profiled_call(run, torch) -> dict:
    """One call of ``run``'s entry under the profiler, read by
    ``trace.read_events`` and ``read_spans``."""
    host = []
    events = trace.profile(torch, lambda: host.append(run.call()))
    base = trace.read_events(events)
    reading = read_spans(events)
    out = {"window_s": base["window_s"], "busy_s": base["busy_s"],
           "device_idle_pct": 100.0 * (1.0 - base["busy_s"]
                                       / base["window_s"]),
           **layer_metrics(reading, base),
           "top_kernels": trace.top(base["kernels"], 5, 64)}
    if reading is not None:
        reading["span_kernels"] = {k: trace.top(v, 3, 64) for k, v in
                                   reading["span_kernels"].items()}
        out.update(reading)
    out["host_spans"] = host[0].get("spans")
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import time

    from bench_cuda import harness, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload, spec.benchmark())
    run = harness.Run(cell, args.seed, "cuda",
                      harness.Clock(time.perf_counter()))
    if args.seconds > 0:
        run.window(args.seconds)
    run.mrrs = []
    for _ in range(args.calls):
        print(json.dumps(profiled_call(run, torch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
