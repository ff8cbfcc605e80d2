"""Structured metrics and profiling: the port's counterpart of
tgb_tgn_dgl_tpu/utils/metrics.py.

  * ``MetricsLogger`` — an append-only jsonl event log (one JSON object
    per line: ``event``, the wall time since the logger opened, and the
    caller's fields);
  * ``profile`` — a context manager around ``torch.profiler`` that writes
    a Chrome trace (``trace.json``, readable by Perfetto) under its
    directory, with the CUDA activity only when the device is CUDA.
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

