"""The port's observability helpers: the span recorder
``SectionTimers`` / ``span`` (tgb_tgn_dgl_tpu_torch/utils/metrics.py), and
the debug plots of utils/visualize.py, which run where matplotlib,
networkx and sklearn import and return None where they do not (as
tests/test_utils_obs.py holds the JAX package's)."""
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import torch

from tgb_tgn_dgl_tpu.utils.visualize import \
    pack_to_networkx as jax_pack_to_networkx
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig, StreamPacker
from tgb_tgn_dgl_tpu_torch.utils import metrics
from tgb_tgn_dgl_tpu_torch.utils.metrics import SectionTimers, profile, span
from tgb_tgn_dgl_tpu_torch.utils.visualize import (pack_to_networkx,
                                                   visualize_embeddings,
                                                   visualize_pack)


def _clock(monkeypatch, ticks):
    clock = iter(ticks)
    monkeypatch.setattr(metrics, "time", SimpleNamespace(
        perf_counter=lambda: next(clock), time=time.time))


def test_section_timers_count_total_and_average(monkeypatch):
    _clock(monkeypatch, [0.0, 0.010, 1.0, 1.030])
    t = SectionTimers()
    for _ in range(2):
        with t.section("pack"):
            pass
    s = t.summary()["pack"]
    assert s["n"] == 2
    assert s["s"] == pytest.approx(0.04)
    assert s["self_s"] == pytest.approx(0.04)
    assert s["s"] / s["n"] == pytest.approx(0.02)


def test_nested_spans_sum_count_and_self_time(monkeypatch):
    # step [0, 10] holds a [1, 3] and b [4, 8]; b holds c [5, 6] twice
    # over ([5, 5.5] and [6, 7]); then a span outside any recorder
    _clock(monkeypatch, [0.0, 1.0, 3.0, 4.0, 5.0, 5.5, 6.0, 7.0, 8.0, 10.0])
    t = SectionTimers()
    with t.install():
        with span("step"):
            with span("step.a"):
                pass
            with span("step.b"):
                for _ in range(2):
                    with span("step.b.c"):
                        pass
    with span("step"):                  # no recorder: not counted, no clock
        pass
    s = t.summary()
    assert {k: v["n"] for k, v in s.items()} == {
        "step": 1, "step.a": 1, "step.b": 1, "step.b.c": 2}
    assert s["step"]["s"] == 10.0 and s["step"]["self_s"] == 4.0
    assert s["step.b"]["s"] == 4.0 and s["step.b"]["self_s"] == 2.5
    assert s["step.b.c"]["s"] == 1.5 == s["step.b.c"]["self_s"]
    assert t.seconds("step.a") == 2.0 and t.seconds("absent") == 0.0
    assert metrics._current is None      # install restores the previous one


def test_span_never_calls_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    t = SectionTimers()
    with t.install():
        with span("step"):
            with t.section("step.embed"):
                torch.ones(4).sum()
    with span("outside"):
        pass
    assert t.summary()["step.embed"]["n"] == 1


def test_annotate_names_a_region_of_the_trace(tmp_path):
    t = SectionTimers()
    with profile(str(tmp_path), device="cpu"):
        with t.install(), span("step"):
            with span("step.embed"):
                torch.ones(8).sum()
        with span("feed"):              # no recorder: the trace alone
            pass
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(names) == ["feed", "step", "step.embed"]
    assert t.summary()["step"]["n"] == 1


def _pack():
    data = synthetic("tiny", num_edges=300, num_nodes=40, msg_dim=4,
                     num_neg=1, seed=2)
    packer = StreamPacker(data.num_nodes, PackerConfig(
        num_neighbors=4, batch_size=100, max_intra_block=8))
    rng = np.random.default_rng(0)
    for lo in (0, 100):
        rows = np.arange(lo, lo + 100)
        src, dst = data.src[rows], data.dst[rows]
        pack = packer.pack(src, dst, data.t[rows], rows, get_block(src, dst),
                           rng.integers(0, 40, 100).astype(np.int32))
    return pack


def test_pack_to_networkx_matches_jax():
    pack = _pack()
    g = pack_to_networkx(pack, max_roots=20)
    if g is None:                       # networkx unavailable
        return
    want = jax_pack_to_networkx(pack, max_roots=20)
    assert sorted(g.edges(keys=True, data=True)) == \
        sorted(want.edges(keys=True, data=True))
    kinds = {d["kind"] for _, _, d in g.edges(data=True)}
    assert kinds <= {"cache", "intra"} and "cache" in kinds


def test_visualize_pack_and_embeddings(tmp_path):
    p1 = visualize_pack(_pack(), path=str(tmp_path / "batch.png"),
                        max_roots=15)
    if p1 is not None:
        assert os.path.exists(p1) and os.path.getsize(p1) > 0
    rng = np.random.default_rng(0)
    p2 = visualize_embeddings(rng.normal(size=(30, 16)),
                              labels=np.arange(30) % 3,
                              path=str(tmp_path / "emb.png"))
    if p2 is not None:
        assert os.path.exists(p2) and os.path.getsize(p2) > 0
