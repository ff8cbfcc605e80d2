"""Shared fixtures of the benchmark's tests: the cells at the
tgbl-wiki-small preset on the CPU (train cells at batch 2,000, so that
the small stream's split has the three steps the check reads), those of
BENCHMARK.json and those kept out of it under ``bench_cuda/kept/``."""
import glob
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = "tgbl-wiki-small"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips itself when "
        "torch.cuda.is_available() is false")


def with_kept(bench):
    """``bench`` with the entries of each ``bench_cuda/kept/<cell>.json``
    (a cell and its metrics, as BENCHMARK.json held them) added."""
    bench = dict(bench)
    for path in sorted(glob.glob(os.path.join(ROOT, "bench_cuda", "kept",
                                              "*.json"))):
        with open(path) as f:
            kept = json.load(f)
        for key, entries in kept.items():
            bench[key] = bench[key] + entries
    return bench


def small_cell(name):
    """The cell ``name`` of BENCHMARK.json or of ``bench_cuda/kept/``, its
    train batch cut to 2,000 for the small stream."""
    from bench_cuda import spec
    cell = spec.cell(name, with_kept(spec.benchmark()))
    if cell.traffic["entry"] == "train_epoch":
        cell = cell._replace(traffic=dict(cell.traffic, batch_size=2000))
    return cell


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
