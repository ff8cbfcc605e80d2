"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``bench_cuda/`` one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell's
correctness limits (``limits/<workload>.json``) and per-layer metric
(``metrics/<name>.py``).  A configuration's file names its plain
reference (``"reference": "bench_cuda/reference/<name>.py"``, the
interface in ``reference/__init__.py``), through which the harness does
everything that depends on the architecture.  A later cell, metric or
configuration, of another architecture too, is added by adding such
files and entries; no file here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
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


def reference(config: dict, entry: str):
    """The plain reference module that ``config`` names, for a cell whose
    traffic runs ``entry``.  Refused, with the configuration and its key
    named, where the key is missing, is not ``bench_cuda/reference/<name>.py``,
    or names a module that lacks a function of the interface (its
    ``COMMON`` and its ``BY_ENTRY[entry]``)."""
    key = config.get("reference")
    where = f"configuration {config.get('name')!r}: reference {key!r}"
    found = (re.fullmatch(rf"{HERE.name}/reference/([A-Za-z_][A-Za-z0-9_]*)"
                          r"\.py", key) if isinstance(key, str) else None)
    if found is None:
        raise ValueError(f"{where}: a configuration names its plain reference "
                         f"as {HERE.name}/reference/<name>.py")
    package = importlib.import_module(f"{HERE.name}.reference")
    name = f"{package.__name__}.{found[1]}"
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"{where}: no module {name}") from None
    needs = package.COMMON + package.BY_ENTRY.get(entry, ())
    missing = [f for f in needs if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f"{where} lacks {', '.join(missing)} of the "
                         f"interface in {HERE.name}/reference/__init__.py")
    return module


def framework_sections(config: dict, traffic: dict, seed: int) -> Dict:
    """The configuration's TGL sections as the program parses them, with
    the traffic's batch size and the run's seed."""
    conf = json.loads(json.dumps(config["tgl"]))
    train = conf["train"][0]
    train["batch_size"] = traffic["batch_size"]
    train["seed"] = seed
    return conf
