"""The Engine's spans (tgb_tgn_dgl_tpu_torch/engine/train.py, recorded by
utils/metrics.py's ``SectionTimers``) on the CPU, on a tiny stream with
the GRU mailbox memory (1,000 events, 100 nodes, batch 100):

  * ``last_epoch_trace`` and ``last_eval_trace`` keep the keys they have
    always had, and ``pack_s``, ``fetch_s``, ``copy_s`` and ``disp_s`` are
    the seconds of ``feed``, ``feed.fetch``, ``feed.copy`` and ``step``;
  * each part of the train step is one span a step, and of the eval
    dispatch one a batch (``step.expand`` and ``step.embed`` one an embed
    chunk), for both eval protocols; the children's seconds add up to no
    more than their parent's;
  * under the CPU profiler every span is a region of the trace, and the
    backward nodes of the memory's GRU carry the sequence numbers of
    forward ops that ran inside ``step.memory.apply``, which is how a
    reading of the trace puts backward work down to its forward span.
"""
import json

import pytest

from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict
from tgb_tgn_dgl_tpu_torch.utils.metrics import profile

RAW = dict(
    sampling=[dict(neighbor=[5])],
    gnn=[dict(att_head=2, dim_out=8, dim_time=8)],
    memory=[dict(dim_out=8, dim_time=8, memory_update="gru")],
    train=[dict(epoch=1, batch_size=100, lr=1e-3, dropout=0.1,
                att_dropout=0.1, frozen_memory=False)],
)
OLD_KEYS = {"total_s", "pack_s", "fetch_s", "copy_s", "disp_s"}
TRAIN_PARTS = ("step.expand", "step.memory.apply", "step.embed",
               "step.backward", "step.memory.commit", "step.adam",
               "step.stats")
EVAL_PARTS = ("step.memory.apply", "step.score", "step.memory.commit")
CHUNK_PARTS = ("step.expand", "step.embed")


def _engine(**train):
    data = synthetic("tiny", num_edges=1000, num_nodes=100, msg_dim=4,
                     num_neg=8, seed=1)
    raw = dict(RAW, train=[dict(RAW["train"][0], **train)])
    return Engine(data, parse_config_dict(raw), device="cpu")


def _check_tree(tr, parts):
    """The old sums are the spans' seconds, each child's seconds lie
    within its parent's, and ``feed`` runs once more than ``step`` (the
    last fetch finds the stream's end)."""
    sp = tr["spans"]
    assert tr["pack_s"] == sp["feed"]["s"] and tr["disp_s"] == sp["step"]["s"]
    assert tr["fetch_s"] == sp["feed.fetch"]["s"]
    assert tr["copy_s"] == sp["feed.copy"]["s"]
    assert sp["feed"]["n"] == sp["step"]["n"] + 1
    for parent, children in (("feed", ("feed.fetch", "feed.copy")),
                             ("step", parts)):
        inner = sum(sp[c]["s"] for c in children)
        assert inner <= sp[parent]["s"]
        assert sp[parent]["self_s"] == pytest.approx(sp[parent]["s"] - inner,
                                                     abs=1e-9)
    assert tr["pack_s"] + tr["disp_s"] <= tr["total_s"]
    assert set(sp) == {"feed", "feed.fetch", "feed.copy", "step", *parts}


@pytest.fixture(scope="module")
def trained():
    eng = _engine()
    eng.train_epoch()
    return eng


def test_train_epoch_spans(trained):
    tr = trained.last_epoch_trace
    assert set(tr) == OLD_KEYS | {"batches", "gather_launches", "spans"}
    assert tr["batches"] == 7
    assert tr["gather_launches"] == 0      # the CPU takes aten's backward
    _check_tree(tr, TRAIN_PARTS)
    for name in ("step",) + TRAIN_PARTS:
        assert tr["spans"][name]["n"] == tr["batches"], name


@pytest.mark.parametrize("protocol", ["slot_unique", "column_chunk"])
def test_eval_pass_spans(trained, protocol):
    snap = trained.snapshot_stream()
    try:
        (trained.evaluate if protocol == "slot_unique"
         else trained._evaluate_chunked)("val")
    finally:
        trained.restore_stream(snap)
    tr = trained.last_eval_trace
    assert tr["protocol"] == protocol
    assert set(tr) == OLD_KEYS | {"protocol", "batches", "embed_chunks",
                                  "score_chunks", "chunks", "spans"}
    _check_tree(tr, EVAL_PARTS + CHUNK_PARTS)
    sp = tr["spans"]
    # the column-chunk protocol dispatches once a chunk; the tiny stream's
    # 8 negatives make one chunk a batch
    assert sp["step"]["n"] == (tr["batches"] if protocol == "slot_unique"
                               else tr["embed_chunks"])
    for name in EVAL_PARTS:
        assert sp[name]["n"] == tr["batches"], name
    for name in CHUNK_PARTS:
        assert sp[name]["n"] == tr["embed_chunks"], name


def _within(ev, outer):
    return (outer["ts"] <= ev["ts"]
            and ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"])


def test_memory_backward_links_to_its_forward_span(tmp_path):
    eng = _engine(sanity_batches=2)
    with profile(str(tmp_path), device="cpu"):
        eng.train_epoch()
    events = [e for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]
        if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in spans}
    assert {"feed", "feed.fetch", "feed.copy", "step"} | set(
        TRAIN_PARTS) <= names
    assert sum(e["name"] == "step" for e in spans) == 2
    apply = [e for e in spans if e["name"] == "step.memory.apply"]
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: e["ts"])
    # forward ops carry "Fwd thread id" 0, backward nodes the id of the
    # thread that ran their forward op; an op records the number the next
    # node takes, so the last op to start with a number made that node
    last = {e["args"]["Sequence number"]: e for e in ops
            if "Sequence number" in e.get("args", {})
            and not e["args"].get("Fwd thread id")}
    fwd = {n for n, e in last.items() if any(_within(e, s) for s in apply)}
    bwd = [e for e in ops
           if e["name"].startswith("autograd::engine::evaluate_function")
           and e["args"].get("Fwd thread id")
           and e["args"].get("Sequence number") in fwd]
    assert fwd and bwd
    # the GRU cell's matmuls and gates come back in the backward
    kinds = {e["name"].split(": ")[1] for e in bwd}
    assert any("Mm" in k or "Addmm" in k for k in kinds), kinds
    # and every such backward node ran inside step.backward
    back = [e for e in spans if e["name"] == "step.backward"]
    assert all(any(_within(e, s) for s in back) for e in bwd)
