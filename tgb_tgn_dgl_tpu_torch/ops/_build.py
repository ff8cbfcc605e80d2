"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so``, where the
hash covers the source and the flags, and loaded with ``ctypes``.  The
build runs at the first CUDA call that needs a library (or when
``build()`` is called, as chip_smoke.py does), never at import: a machine
without ``nvcc`` imports and tests the package on the CPU.  Several
sources build in parallel, one ``nvcc`` process each (``compile_all``,
which the A/B and sweep scripts use for other versions of a source).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return str(path)


def target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def compile_all(jobs: Dict[str, tuple]) -> Dict[str, dict]:
    """Compile each ``name: (source, library)`` with NVCC_FLAGS, all ``nvcc``
    processes started together.  Returns, per name, the seconds it took and
    the compiler's log (``ptxas`` registers and spills).  Raises with the
    compiler's output on failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, out) in jobs.items():
        out = Path(out)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every stale library of ``names`` (default: all sources) with
    ``compile_all``.  Returns its report, with 0 seconds and an empty log
    for a library already built."""
    names = list(names) if names is not None else sources()
    report = {n: {"seconds": 0.0, "log": ""} for n in names}
    report.update(compile_all({n: (CSRC / f"{n}.cu", target(n))
                               for n in names if not target(n).exists()}))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(target(name)))
    return lib
