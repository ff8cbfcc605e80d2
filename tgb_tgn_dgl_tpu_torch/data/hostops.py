"""ctypes bindings of the host preprocessing library (csrc/hostops.cpp):
the port's counterpart of tgb_tgn_dgl_tpu/data/hostops.py.

The library is built at its first use by ``ops/_build.py::host_library``
(g++, into ``_build/libhostops-<hash>.so``), as the packer is; a build that
fails raises.  Nothing here falls back to numpy on its own: the numpy
versions (data/tcsr.py, data/dependency.py) are the plain reference, and a
caller asks for them by name (``impl="numpy"``).

``num_threads`` defaults to min(32, CPUs).  Every entry point gives the
same result whatever the thread count: ``dependency_blocks`` runs one
batch a task, the samplers one query a task, and ``sample_uniform`` draws
from a splitmix64 stream keyed by (seed, query index).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..ops import _build

_DECLARED: set = set()


def _lib() -> ctypes.CDLL:
    """The hostops library, built at first use, its entry points typed."""
    lib = _build.host_library("hostops")
    if id(lib) in _DECLARED:
        return lib
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c = ctypes
    lib.dependency_blocks.argtypes = [i32p, i32p, c.c_int64, c.c_int64,
                                      c.c_int32, i32p]
    lib.dependency_blocks.restype = None
    lib.build_tcsr.argtypes = [i32p, i32p, f32p, c.c_int64, c.c_int64,
                               i64p, i32p, i32p, f32p]
    lib.build_tcsr.restype = None
    # t-CSR (indptr, indices, eid, ts), queries (nodes, times, count), K,
    # [seed], threads, out (nbr, eid, ts)
    lib.sample_recent.argtypes = [i64p, i32p, i32p, f32p, i32p, f32p,
                                  c.c_int64, c.c_int32, c.c_int32,
                                  i32p, i32p, f32p]
    lib.sample_recent.restype = None
    lib.sample_uniform.argtypes = [i64p, i32p, i32p, f32p, i32p, f32p,
                                   c.c_int64, c.c_int32, c.c_uint64,
                                   c.c_int32, i32p, i32p, f32p]
    lib.sample_uniform.restype = None
    _DECLARED.add(id(lib))
    return lib


def _threads(num_threads: Optional[int]) -> int:
    return num_threads or min(32, os.cpu_count() or 1)


def _check_nodes(name: str, ids: np.ndarray, num_nodes: int) -> None:
    """The C++ indexes its arrays by these ids unchecked."""
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= num_nodes):
        raise ValueError(f"{name}: node ids must lie in [0, {num_nodes})")


def dependency_blocks(src: np.ndarray, dst: np.ndarray, batch_size: int,
                      num_threads: Optional[int] = None) -> np.ndarray:
    """Block id of every event, batch by batch (int32 src/dst)."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    out = np.empty(len(src), dtype=np.int32)
    _lib().dependency_blocks(src, dst, len(src), batch_size,
                             _threads(num_threads), out)
    return out


def build_tcsr(src, dst, t, num_nodes: int):
    """Undirected t-CSR (indptr, indices, eid, ts), the TGL ext_full.npz
    layout (reference utils.py:73); events in chronological order."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    t = np.ascontiguousarray(t, np.float32)
    if not len(src) == len(dst) == len(t):
        raise ValueError("build_tcsr: src, dst and t differ in length")
    _check_nodes("build_tcsr", src, num_nodes)
    _check_nodes("build_tcsr", dst, num_nodes)
    E = len(src)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    indices = np.empty(2 * E, dtype=np.int32)
    eid = np.empty(2 * E, dtype=np.int32)
    ts = np.empty(2 * E, dtype=np.float32)
    _lib().build_tcsr(src, dst, t, E, num_nodes, indptr, indices, eid, ts)
    return indptr, indices, eid, ts


def _queries(indptr, nodes, times):
    nodes = np.ascontiguousarray(nodes, np.int32)
    times = np.ascontiguousarray(times, np.float32)
    if len(nodes) != len(times):
        raise ValueError("sample: nodes and times differ in length")
    _check_nodes("sample", nodes, len(indptr) - 1)
    return nodes, times


def _out(n: int, k: int):
    return (np.empty((n, k), np.int32), np.empty((n, k), np.int32),
            np.empty((n, k), np.float32))


def sample_recent(indptr, indices, eid, ts, nodes, times, k: int,
                  num_threads: Optional[int] = None):
    """The K most recent neighbors before each query time."""
    nodes, times = _queries(indptr, nodes, times)
    nbr, out_eid, out_ts = _out(len(nodes), k)
    _lib().sample_recent(indptr, indices, eid, ts, nodes, times, len(nodes),
                         k, _threads(num_threads), nbr, out_eid, out_ts)
    return nbr, out_eid, out_ts


def sample_uniform(indptr, indices, eid, ts, nodes, times, k: int,
                   seed: int = 0, num_threads: Optional[int] = None):
    """min(K, history) uniform draws (with replacement) from each query's
    history before its time, keyed by (seed, query index)."""
    nodes, times = _queries(indptr, nodes, times)
    nbr, out_eid, out_ts = _out(len(nodes), k)
    _lib().sample_uniform(indptr, indices, eid, ts, nodes, times, len(nodes),
                          k, seed, _threads(num_threads), nbr, out_eid,
                          out_ts)
    return nbr, out_eid, out_ts
