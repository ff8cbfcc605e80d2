"""The port's observability helpers: ``SectionTimers`` and ``annotate``
(tgb_tgn_dgl_tpu_torch/utils/metrics.py), and the debug plots of
utils/visualize.py, which run where matplotlib, networkx and sklearn
import and return None where they do not (as tests/test_utils_obs.py
holds the JAX package's)."""
import os
import time
from types import SimpleNamespace

import numpy as np

import torch

from tgb_tgn_dgl_tpu.utils.visualize import \
    pack_to_networkx as jax_pack_to_networkx
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig, StreamPacker
from tgb_tgn_dgl_tpu_torch.utils import metrics
from tgb_tgn_dgl_tpu_torch.utils.metrics import (SectionTimers, annotate,
                                                 profile)
from tgb_tgn_dgl_tpu_torch.utils.visualize import (pack_to_networkx,
                                                   visualize_embeddings,
                                                   visualize_pack)


def test_section_timers_count_total_and_average(monkeypatch):
    clock = iter([0.0, 0.010, 1.0, 1.030])
    monkeypatch.setattr(metrics, "time", SimpleNamespace(
        perf_counter=lambda: next(clock), time=time.time))
    t = SectionTimers(alpha=0.5)
    for _ in range(2):
        with t.section("pack"):
            pass
    s = t.summary()["pack"]
    assert s["count"] == 2
    assert s["total_s"] == 0.04
    assert s["mean_ms"] == 20.0
    assert s["ema_ms"] == 20.0          # 0.5 · 10 + 0.5 · 30


def test_annotate_names_a_region_of_the_trace(tmp_path):
    with profile(str(tmp_path), device="cpu"):
        with annotate("uniform_pack"):
            torch.ones(8).sum()
    trace = (tmp_path / "trace.json").read_text()
    assert "uniform_pack" in trace


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
