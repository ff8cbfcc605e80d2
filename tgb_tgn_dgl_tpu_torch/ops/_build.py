"""Build and load the port's hand-written CUDA kernels and its host C++.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so``, where the
hash covers the source and the flags, and loaded with ``ctypes``.  The
build runs at the first CUDA call that needs a library, which builds the
other stale sources beside it (or when ``build()`` is called, as
chip_smoke.py does), never at import: a machine without ``nvcc`` imports
and tests the package on the CPU.  Several sources build in parallel, one
``nvcc`` process each (``compile_all``, which the A/B and sweep scripts use
for other versions of a source).

Each ``csrc/<name>.cpp`` is host code (the stream packer, the multi-host
exchange's node-range owners): ``g++`` with
``CXX_FLAGS`` builds it at its first use (``host_library``) into
``_build/lib<name>-<hash>.so``, where the hash also covers the compiler
and the CPU's identity, since ``-march=native`` code built on one CPU may
not run on another.  A failed or missing compiler raises with its output:
nothing falls back to a slower copy.
"""
from __future__ import annotations

import ctypes
import fcntl
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
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

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


def compile_all(jobs: Dict[str, tuple],
                must: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile each ``name: (source, library)`` with NVCC_FLAGS, all ``nvcc``
    processes started together.  Returns, per name, the seconds it took and
    the compiler's log (``ptxas`` registers and spills).  Raises with the
    compiler's output when a job of ``must`` (default: every job) fails;
    any other failed job is left unbuilt, its report marked ``failed``."""
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
            tmp.unlink(missing_ok=True)
            report[name]["failed"] = True
            if must is None or name in must:
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
    """The loaded library of ``csrc/<name>.cu``.  The first call that finds
    it unbuilt also builds the other stale sources in the same parallel
    ``nvcc`` round, so that one process pays for one round; a sibling that
    fails to compile does not stop ``name`` (its own first call raises)."""
    lib = _loaded.get(name)
    if lib is None:
        if not target(name).exists():
            compile_all({n: (CSRC / f"{n}.cu", target(n)) for n in sources()
                         if not target(n).exists()}, must=[name])
        lib = _loaded[name] = ctypes.CDLL(str(target(name)))
    return lib


# ---------------------------------------------------------------- host C++
def host_sources() -> list:
    """Names of every host source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cpp"))


def _cpu_identity() -> bytes:
    """The CPU's model and feature lines: the code that ``-march=native``
    emits depends on them."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = {}
    for line in lines:
        key = line.split(":")[0].strip()
        if key in ("model name", "flags", "Features", "CPU part"):
            keep.setdefault(key, line)
    return "\n".join(keep[k] for k in sorted(keep)).encode()


def host_target(name: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    key = b"\0".join([src, CXX.encode(), " ".join(CXX_FLAGS).encode(),
                      _cpu_identity()])
    return BUILD / f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def compiler_version() -> str:
    """The first line of ``CXX --version``."""
    out = subprocess.run([CXX, "--version"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.splitlines()[0] if out.stdout else out.stderr.strip()


def build_host(name: str) -> dict:
    """Compile ``csrc/<name>.cpp`` with ``CXX`` unless its library exists.
    Returns the seconds it took (0 when built already) and the compiler's
    log; raises with the compiler's output on failure.  Processes that
    build at once take turns on an ``flock`` (released when its holder
    dies) and each writes a temporary file that ``os.replace`` moves in."""
    out = host_target(name)
    if out.exists():
        return {"seconds": 0.0, "log": ""}
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return {"seconds": 0.0, "log": ""}
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the host compiler {CXX!r} for "
                               f"csrc/{name}.cpp: {e}") from e
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed for csrc/{name}.cpp (exit "
                               f"{proc.returncode}):\n{log}")
        os.replace(tmp, out)
        return {"seconds": time.perf_counter() - t0, "log": log}


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, built first if needed."""
    out = host_target(name)
    lib = _loaded.get(str(out))
    if lib is None:
        build_host(name)
        lib = _loaded[str(out)] = ctypes.CDLL(str(out))
    return lib
