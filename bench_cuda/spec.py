"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``bench_cuda/`` one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell's
correctness limits (``limits/<workload>.json``) and per-layer metric
(``metrics/<name>.py``).  A later cell, configuration or metric is added
by adding such files and entries; no file here names one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    workload: dict           # the BENCHMARK.json entry
    config: dict             # configs/<config>.json
    traffic: dict            # traffic/<traffic>.json
    limits: dict             # limits/<workload>.json
    end_to_end: List[dict]   # the metrics this cell reports untraced
    per_layer: List[dict]    # the metrics its traced run reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: dict, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` with every file it names."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, name) and m["moves"] in e2e_names]
    return Cell(workload=w,
                config=load_json(here / "configs" / f"{w['config']}.json"),
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(here / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, here: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_cuda_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def framework_sections(config: dict, traffic: dict, seed: int) -> Dict:
    """The configuration's TGL sections as the program parses them, with
    the traffic's batch size and the run's seed."""
    conf = json.loads(json.dumps(config["tgl"]))
    train = conf["train"][0]
    train["batch_size"] = traffic["batch_size"]
    train["seed"] = seed
    return conf
