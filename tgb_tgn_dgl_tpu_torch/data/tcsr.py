"""Temporal CSR (t-CSR) graphs and strategy-based neighbor sampling: the
port's counterpart of tgb_tgn_dgl_tpu/data/tcsr.py.

The reference's README contracts an external TGL sampler over a t-CSR
built by an absent generator (reference README.md:1-5; the mmap'd
``ext_full.npz`` consumed at utils.py:73), with ``sampling.strategy:
'recent' | 'uniform'`` (config/TGN.yml:7).  The 'recent' strategy is the
streaming recency cache of the packers; this module holds the t-CSR itself
and both query-time strategies over the full history.

Two implementations of each function, chosen by ``impl``:

  * ``"cpp"`` (the default, the Engine's path): csrc/hostops.cpp through
    data/hostops.py, multithreaded, built at first use; a failed build
    raises;
  * ``"numpy"``: the plain reference.  Its 'uniform' draws come from
    ``np.random.default_rng(seed)``, so they are another function of the
    seed than the C++ splitmix64 stream: each is held against its own
    counterpart in the JAX package.

Layout (TGL ext_full.npz): indptr (N+1,) int64, indices (2E,) int32,
eid (2E,) int32, ts (2E,) float32 — undirected, per-node time-sorted.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from . import hostops

IMPLS = ("cpp", "numpy")
STRATEGIES = ("recent", "uniform")


class TCSR(NamedTuple):
    indptr: np.ndarray
    indices: np.ndarray
    eid: np.ndarray
    ts: np.ndarray

    def save_npz(self, path: str) -> None:
        """Write the TGL ext_full.npz layout (reference utils.py:73)."""
        np.savez(path, indptr=self.indptr, indices=self.indices,
                 eid=self.eid, ts=self.ts)

    @staticmethod
    def load_npz(path: str) -> "TCSR":
        z = np.load(path)
        return TCSR(indptr=z["indptr"], indices=z["indices"],
                    eid=z["eid"], ts=z["ts"])


def _check(impl: str, strategy: str = "recent") -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy '{strategy}'")


def build_tcsr(src: np.ndarray, dst: np.ndarray, t: np.ndarray,
               num_nodes: int, impl: str = "cpp") -> TCSR:
    """The undirected t-CSR of a chronological event stream."""
    _check(impl)
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    t = np.ascontiguousarray(t, np.float32)
    if impl == "cpp":
        return TCSR(*hostops.build_tcsr(src, dst, t, num_nodes))
    # counting sort: chronological input keeps each adjacency time-sorted
    E = len(src)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    np.add.at(indptr, dst + 1, 1)
    np.cumsum(indptr, out=indptr)
    indices = np.empty(2 * E, np.int32)
    eid = np.empty(2 * E, np.int32)
    ts = np.empty(2 * E, np.float32)
    cursor = indptr[:-1].copy()
    for e in range(E):
        cs = cursor[src[e]]
        cursor[src[e]] += 1
        indices[cs], eid[cs], ts[cs] = dst[e], e, t[e]
        cd = cursor[dst[e]]
        cursor[dst[e]] += 1
        indices[cd], eid[cd], ts[cd] = src[e], e, t[e]
    return TCSR(indptr=indptr, indices=indices, eid=eid, ts=ts)


def sample(tcsr: TCSR, nodes: np.ndarray, times: np.ndarray, k: int,
           strategy: str = "recent", seed: int = 0,
           num_threads: Optional[int] = None, impl: str = "cpp"):
    """K neighbors per (node, time) query with edge time strictly before
    the query time.  Returns (nbr (n, K), eid (n, K; -1 pad), ts (n, K)).
    'recent' takes the last min(K, history) edges in time order;
    'uniform' min(K, history) draws with replacement, keyed by ``seed``."""
    _check(impl, strategy)
    nodes = np.ascontiguousarray(nodes, np.int32)
    times = np.ascontiguousarray(times, np.float32)
    if impl == "cpp":
        if strategy == "recent":
            return hostops.sample_recent(tcsr.indptr, tcsr.indices,
                                         tcsr.eid, tcsr.ts, nodes, times,
                                         k, num_threads)
        return hostops.sample_uniform(tcsr.indptr, tcsr.indices, tcsr.eid,
                                      tcsr.ts, nodes, times, k, seed,
                                      num_threads)
    n = len(nodes)
    nbr = np.zeros((n, k), np.int32)
    out_eid = np.full((n, k), -1, np.int32)
    out_ts = np.zeros((n, k), np.float32)
    rng = np.random.default_rng(seed)
    for q in range(n):
        v, tq = int(nodes[q]), float(times[q])
        lo, hi = int(tcsr.indptr[v]), int(tcsr.indptr[v + 1])
        cut = lo + int(np.searchsorted(tcsr.ts[lo:hi], tq, side="left"))
        avail = cut - lo
        if avail <= 0:
            continue
        take = min(k, avail)
        if strategy == "recent":
            sel = np.arange(cut - take, cut)
        else:
            sel = lo + rng.integers(0, avail, take)
        nbr[q, :take] = tcsr.indices[sel]
        out_eid[q, :take] = tcsr.eid[sel]
        out_ts[q, :take] = tcsr.ts[sel]
    return nbr, out_eid, out_ts
