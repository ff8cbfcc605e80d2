"""The plain reference comes from the configuration: a second
configuration file that names ``reference/tgn.py`` reads what
``tgn_memory`` reads; every call the harness makes into a reference goes
through the module the configuration names; a configuration whose
reference is missing, lies elsewhere or lacks a function of the
interface is refused before the program's ``Engine`` is built.  On the
CPU at the tgbl-wiki-small preset."""
import json
import os
import re
import shutil
import sys
import time
import types

import pytest
import torch

from conftest import ROOT, SMALL, small_cell

TRAIN = "tgn_memory.wiki.train_b8000"
VAL = "tgn_memory.wiki.val"
STUB = "bench_cuda.reference.recording_stub"


def _numbers(cell, seed):
    from bench_cuda import harness
    run = harness.Run(cell, seed, "cpu", harness.Clock(time.perf_counter()),
                      SMALL)
    run.outputs()
    return run.numbers(run.reference())


def test_second_configuration_reads_the_same(tmp_path):
    """A copy of the benchmark's data with a second configuration, the
    first under another name: its train cell's compared numbers are
    tgn_memory's for the same seed, bit for bit."""
    from bench_cuda import spec
    here = tmp_path / "bench_cuda"
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(os.path.join(ROOT, "bench_cuda", sub), here / sub)
    config = spec.load_json(here / "configs" / "tgn_memory.json")
    assert config["reference"] == "bench_cuda/reference/tgn.py"
    config["name"] = "tgn_twin"
    (here / "configs" / "tgn_twin.json").write_text(json.dumps(config))
    twin = "tgn_twin." + TRAIN.split(".", 1)[1]
    shutil.copy(here / "limits" / f"{TRAIN}.json",
                here / "limits" / f"{twin}.json")
    bench = spec.benchmark()
    w = next(w for w in bench["workloads"] if w["name"] == TRAIN)
    bench["workloads"].append(dict(w, name=twin, config="tgn_twin"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if TRAIN in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + [twin]
    cell = spec.cell(twin, bench, here)
    cell = cell._replace(traffic=dict(cell.traffic, batch_size=2000))
    assert cell.config["name"] == "tgn_twin"
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in small_cell(TRAIN).per_layer]
    # one intra-op thread: the CPU's threaded reductions do not repeat
    # their bits from run to run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got, want = _numbers(cell, 4), _numbers(small_cell(TRAIN), 4)
    finally:
        torch.set_num_threads(threads)
    assert set(got) >= set(cell.limits)
    assert got == want


def _recording_stub(calls):
    """A reference module that records each interface call by name and
    hands it on to ``reference/tgn.py``."""
    from bench_cuda import reference
    from bench_cuda.reference import tgn
    stub = types.ModuleType(STUB)
    for name in reference.COMMON + sum(reference.BY_ENTRY.values(), ()):
        def call(*args, _name=name, **kwargs):
            calls.append(_name)
            return getattr(tgn, _name)(*args, **kwargs)
        setattr(stub, name, call)
    return stub


def _with_reference(cell, key):
    return cell._replace(config=dict(cell.config, reference=key))


def test_every_reference_call_goes_through_the_configured_module(
        monkeypatch):
    from bench_cuda import harness, reference
    source = open(harness.__file__).read()
    assert not re.search(r"from \.reference|reference import|import tgn",
                         source)
    calls = []
    monkeypatch.setitem(sys.modules, STUB, _recording_stub(calls))
    key = "bench_cuda/reference/recording_stub.py"
    seen = {}
    for name in (TRAIN, VAL):
        cell = _with_reference(small_cell(name), key)
        res = harness.run_cell(cell, 8, 0.1, True, "cpu",
                               harness.Clock(time.perf_counter()), SMALL,
                               log=lambda msg: None)
        assert res["correct"], res["checks"]
        # the CPU has no device trace: the span metrics stay out, not 0
        assert not {m for m in res["metrics"] if m.split(".")[0] in (
            "memory_device_ms", "idle_in_step_pct", "launches_per_step",
            "idle_in_feed_pct")}
        seen[name] = set(calls)
        calls.clear()
    assert seen[TRAIN] == set(reference.COMMON
                              + reference.BY_ENTRY["train_epoch"])
    assert seen[VAL] == set(reference.COMMON
                            + reference.BY_ENTRY["evaluate"])


@pytest.mark.parametrize("case", ["missing", "outside", "up", "absent",
                                  "lacking"])
def test_a_reference_is_refused_before_the_engine(case, monkeypatch):
    from bench_cuda import harness
    from tgb_tgn_dgl_tpu_torch.engine import train

    def no_engine(*args, **kwargs):
        raise AssertionError("an Engine was built")
    monkeypatch.setattr(train, "Engine", no_engine)
    cell = small_cell(TRAIN)
    key = {"missing": None,
           "outside": "tgb_tgn_dgl_tpu_torch/models/tgnn.py",
           "up": "bench_cuda/reference/../spec.py",
           "absent": "bench_cuda/reference/no_such_reference.py",
           "lacking": "bench_cuda/reference/recording_stub.py"}[case]
    if key is None:
        cell = cell._replace(config={k: v for k, v in cell.config.items()
                                     if k != "reference"})
    else:
        cell = _with_reference(cell, key)
    if case == "lacking":
        stub = _recording_stub([])
        del stub.layer_context
        monkeypatch.setitem(sys.modules, STUB, stub)
    with pytest.raises(ValueError) as refused:
        harness.Run(cell, 1, "cpu", harness.Clock(time.perf_counter()),
                    SMALL)
    msg = str(refused.value)
    assert "'tgn_memory'" in msg and repr(key) in msg
    if case == "lacking":
        assert "layer_context" in msg
