"""The whole harness on the CPU at the tgbl-wiki-small preset (the plain
path of the port), BENCHMARK.json against the benchmark's contract, and
the command's refusals: no card, or no program beside the benchmark."""
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from conftest import ROOT, SMALL, small_cell, with_kept

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kept", [False, True])
def test_benchmark_json_keeps_the_contract(kept):
    """BENCHMARK.json, and BENCHMARK.json with the kept cells put back."""
    b = with_kept(_bench()) if kept else _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench_cuda"] and 1 <= b["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    configs = {c["name"]: c for c in b["configs"]}
    cells = {w["name"]: w for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(configs) + list(cells) + list(e2e) + [
        m["name"] for m in b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("bench_cuda/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    here = os.path.join(ROOT, "bench_cuda")
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        for sub in ("traffic", "limits"):
            key = w["traffic"] if sub == "traffic" else w["name"]
            assert os.path.exists(os.path.join(here, sub, f"{key}.json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(here, "metrics",
                                           f"{m['name']}.py"))
    for w in cells:
        got = [m["name"] for m in b["end_to_end"]
               if w in m.get("workloads", cells)]
        assert "setup_s" in got and len(got) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


@pytest.mark.parametrize("name,traced", [
    ("tgn_memory.wiki.train_b8000", False),
    ("tgn_memory.wiki.train_b8000", True),
    ("tgn_memory.wiki.val", True)])
def test_whole_run_on_cpu(name, traced):
    from bench_cuda import harness
    cell = small_cell(name)
    res = harness.run_cell(cell, 5, 0.5, traced, "cpu",
                           harness.Clock(time.perf_counter()), SMALL,
                           log=lambda msg: None)
    line = harness.result_line(res, traced, {"platform": "gpu",
                                              "kind": "cpu", "count": 1})
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["checks"]) == set(cell.limits)
    units = {m["name"]: m["unit"]
             for m in (cell.per_layer if traced else cell.end_to_end)}
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and v["value"] > 0
    if traced:
        # the CPU has no device trace: the readers of device time stay out
        host = {k for k in units if k.split(".")[0] in (
            "pack_wait_pct", "wire_copy_pct", "dispatch_pct")}
        assert host <= set(line["metrics"])
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert set(line["metrics"]) == set(units)
    json.dumps(line)


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench_cuda/run.py", "--workload",
         "tgn_memory.wiki.train_b8000", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_cuda"),
                    tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _command(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
