"""Structured metrics and profiling: the port's counterpart of
tgb_tgn_dgl_tpu/utils/metrics.py.

  * ``MetricsLogger`` — an append-only jsonl event log (one JSON object
    per line: ``event``, the wall time since the logger opened, and the
    caller's fields);
  * ``SectionTimers`` and ``span`` — the port's one span recorder:
    named, nested sections of the host's time (seconds, self seconds,
    counts) that are also named regions of a profiler trace while one
    records (``torch.profiler.record_function``, the counterpart of
    ``jax.profiler.TraceAnnotation``);
  * ``profile`` — a context manager around ``torch.profiler`` that writes
    a Chrome trace (``trace.json``, readable by Perfetto) under its
    directory, with the CUDA activity only when the device is CUDA.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"


class MetricsLogger:
    """Append-only jsonl metrics sink.

    >>> m = MetricsLogger("runs/exp1")   # writes runs/exp1/metrics.jsonl
    >>> m.log("train_epoch", epoch=1, loss=12.3, ap=0.9)
    """

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._fh = None
        self._t0 = time.time()
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                            buffering=1)

    def log(self, event: str, **fields) -> Dict:
        rec = {"event": event, "wall_s": round(time.time() - self._t0, 4),
               **fields}
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class SectionTimers:
    """The port's span recorder: named, nested sections of the host's
    time, each with its seconds (``s``), its self seconds (``self_s``: its
    seconds less its children's) and its count (``n``).  While a
    torch.profiler records, each section is also a ``record_function`` of
    the same name, so that it lands in the profiler's trace on the
    profiler's clock; with none recording it never touches one (a span
    then costs a flag check and two clock reads).

    >>> t = SectionTimers()
    >>> with t.section("feed"):
    ...     with t.section("feed.copy"):
    ...         pass
    >>> t.summary()["feed.copy"]["n"]
    1

    Code below an entry point reaches the recorder the entry point
    ``install``-ed through ``span(name)``, with no argument passed down.
    """

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.own: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        # per open section, the seconds of its closed children
        self._open: List[float] = []

    def section(self, name: str) -> "_Span":
        """A context manager: one span of ``name`` on this recorder."""
        return _Span(self, name)

    def seconds(self, name: str) -> float:
        return self.total.get(name, 0.0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per section name: ``s``, ``self_s`` and ``n``."""
        return {name: {"s": self.total[name], "self_s": self.own[name],
                       "n": self.count[name]} for name in self.total}

    @contextlib.contextmanager
    def install(self):
        """Make this the recorder ``span`` reports to, for the block."""
        global _current
        prev, _current = _current, self
        try:
            yield self
        finally:
            _current = prev


# the recorder ``span`` reports to (``SectionTimers.install``), or None
_current: Optional[SectionTimers] = None
# whether a torch profiler records (the flag ``record_function`` reads)
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("rec", "name", "fn", "t0")

    def __init__(self, rec: Optional[SectionTimers], name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.fn = None
        if _profiling():
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        if self.rec is not None:
            self.rec._open.append(0.0)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            dt = time.perf_counter() - self.t0
            name = self.name
            rec.total[name] = rec.total.get(name, 0.0) + dt
            rec.own[name] = rec.own.get(name, 0.0) + dt - rec._open.pop()
            rec.count[name] = rec.count.get(name, 0) + 1
            if rec._open:
                rec._open[-1] += dt
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def span(name: str) -> _Span:
    """A section of the installed recorder (none: only the profiler's
    ``record_function``, while one records)."""
    return _Span(_current, name)


@contextlib.contextmanager
def profile(log_dir: str, device="cuda"):
    """torch.profiler trace around a region, written as
    ``<log_dir>/trace.json``; CUDA is traced when ``device`` is a CUDA
    device, the host always."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))

