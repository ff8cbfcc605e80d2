"""Dependency-aware intra-batch blocking — the reference's core idea.

Re-implementation of reference dependencyGraph.py:8-49: within each batch,
events are leveled into "blocks" such that no node appears twice in one
block; an event's block id is 1 + max(last block touching its src, its
dst), reset per batch.  Blocks are processed in order by the model with
the invariant that block-i positive edges become message-passing edges for
blocks > i (model_utils.py:151-157).

Invariants (tested for the JAX package in tests/test_dependency.py;
``check_block_invariants`` asserts the first):
  * no node appears in two events of the same block (src/dst only —
    negatives do not participate, dependencyGraph.py:14);
  * per node, the block ids of its events are strictly increasing;
  * block(e) = 0 iff neither endpoint was seen earlier in the batch.

The O(B) leveling loop is pointer chasing, so it runs on the host: the
port's copy of tgb_tgn_dgl_tpu/data/dependency.py, with the multithreaded
C++ leveler of csrc/hostops.cpp (one batch a task; the Engine's path) and
the numpy one beside it as the plain reference, which gives the same
blocks (``impl="numpy"``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import hostops


def get_block(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Level one batch of events into dependency blocks.

    Parity with reference dependencyGraph.py:8-28 (the per-node
    ``last_accessed_dict``), expressed over a scratch array keyed by the
    batch-local compressed node ids instead of a python dict.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    # Compress node ids to batch-local to keep the scratch small.
    nodes, inv = np.unique(np.stack([src, dst]), return_inverse=True)
    inv = inv.reshape(2, -1)
    s, d = inv[0], inv[1]
    last = np.full(len(nodes), -1, dtype=np.int64)
    out = np.empty(len(src), dtype=np.int32)
    for i in range(len(src)):
        b = max(last[s[i]], last[d[i]]) + 1
        out[i] = b
        last[s[i]] = b
        last[d[i]] = b
    return out


def dependency_aware_batch(
    src: np.ndarray,
    dst: np.ndarray,
    batch_size: int,
    impl: str = "cpp",
    num_threads: Optional[int] = None,
) -> np.ndarray:
    """Block ids for every event of a split, batch by batch (flat): the
    C++ leveler (``impl="cpp"``) or the numpy one (``"numpy"``).

    Parity with reference ``dependecyAwareBatch`` (dependencyGraph.py:33-49)
    Note the reference computes blocks
    per *split* and the driver swaps val/test by accident (utils.py:56-57,
    SURVEY.md §7.5) — we compute per split correctly.
    """
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if impl == "cpp":
        return hostops.dependency_blocks(src, dst, batch_size, num_threads)
    if impl != "numpy":
        raise ValueError(f"unknown impl {impl!r}; expected 'cpp' or 'numpy'")
    n = len(src)
    blocks = np.empty(n, dtype=np.int32)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        blocks[lo:hi] = get_block(src[lo:hi], dst[lo:hi])
    return blocks



def check_block_invariants(src, dst, blocks, batch_size) -> None:
    """Assertion pass for the race-avoidance invariant: raises if a node
    appears twice within one (batch, block), unless the batch holds a
    self-edge (src == dst puts its node twice in a block legitimately)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    blocks = np.asarray(blocks)
    for lo in range(0, len(src), batch_size):
        hi = min(lo + batch_size, len(src))
        b = blocks[lo:hi]
        nodes = np.concatenate([src[lo:hi], dst[lo:hi]])
        bb = np.concatenate([b, b])
        pairs = nodes.astype(np.int64) * (b.max() + 1 if len(b) else 1) + bb
        _, counts = np.unique(pairs, return_counts=True)
        self_edges = src[lo:hi] == dst[lo:hi]
        if counts.max(initial=1) > 1 and not self_edges.any():
            raise AssertionError(
                f"dependency-block invariant violated in batch @{lo}")
