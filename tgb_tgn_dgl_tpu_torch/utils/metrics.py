"""Structured metrics and profiling: the port's counterpart of
tgb_tgn_dgl_tpu/utils/metrics.py.

  * ``MetricsLogger`` — an append-only jsonl event log (one JSON object
    per line: ``event``, the wall time since the logger opened, and the
    caller's fields);
  * ``SectionTimers`` — named wall-clock section timers with exponential
    moving averages (the per-section breakdown of a pipeline);
  * ``profile`` — a context manager around ``torch.profiler`` that writes
    a Chrome trace (``trace.json``, readable by Perfetto) under its
    directory, with the CUDA activity only when the device is CUDA;
  * ``annotate`` — a named region inside such a trace
    (``torch.profiler.record_function``, the counterpart of
    ``jax.profiler.TraceAnnotation``).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

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
    """Named wall-clock section timers with exponential moving averages —
    the per-section breakdown (pack / transfer / device / metrics) that
    identifies a pipeline's bottleneck.

    >>> t = SectionTimers()
    >>> with t.section("pack"):
    ...     pass
    >>> t.summary()["pack"]["count"]
    1
    """

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Dict[str, float] = {}
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.ema[name] = (dt if name not in self.ema
                              else (1 - self.alpha) * self.ema[name]
                              + self.alpha * dt)
            self.total[name] = self.total.get(name, 0.0) + dt
            self.count[name] = self.count.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per section: the moving average and the mean in ms, the total
        in s, the count."""
        return {
            name: {
                "ema_ms": round(self.ema[name] * 1e3, 3),
                "mean_ms": round(self.total[name] / self.count[name] * 1e3,
                                 3),
                "total_s": round(self.total[name], 3),
                "count": self.count[name],
            }
            for name in self.total
        }


@contextlib.contextmanager
def profile(log_dir: str, device="cuda"):
    """torch.profiler trace around a region, written as
    ``<log_dir>/trace.json``; CUDA is traced when ``device`` is a CUDA
    device, the host always."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named region inside a ``profile`` trace (a context manager)."""
    import torch

    return torch.profiler.record_function(name)
