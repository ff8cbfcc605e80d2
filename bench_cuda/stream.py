"""The benchmark's traffic generator: a frozen copy of the port's
``tgb_tgn_dgl_tpu_torch/data/dataset.py::synthetic`` (the tgbl-* presets
and the stream they generate), so that a later change to the program
cannot change the traffic it is measured on.

The arithmetic is the program's, draw for draw (``bench_cuda/tests`` hold
the two equal).  One argument is new: ``neg_splits`` names the splits
whose fixed eval negatives are drawn, since a train cell needs none and
the (E_split, M) draws of a split at M = 999 take a second each.  The
val negatives are drawn before the test ones, as in the original, so
leaving the test split out changes none of the val draws.

The result is a plain ``Stream`` of numpy arrays; the harness hands it to
the program as the program's own ``TemporalData``, and the plain reference
(``bench_cuda/reference``) reads the same arrays.
"""
from __future__ import annotations

import hashlib
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np

# tgbl-* scale presets: (num_edges, num_nodes, msg_dim, num_eval_negatives)
SYNTHETIC_PRESETS: Dict[str, Dict] = {
    "tgbl-wiki": dict(num_edges=157_474, num_nodes=9_227, msg_dim=172, num_neg=999),
    "tgbl-review": dict(num_edges=4_730_000, num_nodes=352_637, msg_dim=1, num_neg=100),
    "tgbl-coin": dict(num_edges=22_809_486, num_nodes=638_486, msg_dim=1, num_neg=20),
    "tgbl-comment": dict(num_edges=44_314_507, num_nodes=994_790, msg_dim=2, num_neg=20),
    "tgbl-flight": dict(num_edges=67_169_570, num_nodes=18_143, msg_dim=16, num_neg=20),
    "tgbl-wiki-small": dict(num_edges=20_000, num_nodes=1_200, msg_dim=32, num_neg=32),
}


class Stream(NamedTuple):
    """The event stream, its chronological split and its fixed eval
    negatives (None for a split that was not drawn)."""

    name: str
    src: np.ndarray            # (E,) int32
    dst: np.ndarray            # (E,) int32
    t: np.ndarray              # (E,) float32
    msg: np.ndarray            # (E, F) float32
    train_mask: np.ndarray     # (E,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    val_ns: Optional[np.ndarray]
    test_ns: Optional[np.ndarray]

    @property
    def num_nodes(self) -> int:
        return int(max(self.src.max(), self.dst.max())) + 1


def chronological_masks(num_edges: int, val_ratio=0.15, test_ratio=0.15):
    """TGB's chronological 70/15/15 split convention."""
    n_val = int(num_edges * val_ratio)
    n_test = int(num_edges * test_ratio)
    n_train = num_edges - n_val - n_test
    train = np.zeros(num_edges, bool)
    val = np.zeros(num_edges, bool)
    test = np.zeros(num_edges, bool)
    train[:n_train] = True
    val[n_train:n_train + n_val] = True
    test[n_train + n_val:] = True
    return train, val, test


def synthetic(
    name: str = "tgbl-wiki-small",
    num_edges: Optional[int] = None,
    num_nodes: Optional[int] = None,
    msg_dim: Optional[int] = None,
    num_neg: Optional[int] = None,
    seed: int = 0,
    bipartite: bool = True,
    neg_splits: Sequence[str] = ("val", "test"),
) -> Stream:
    """Deterministic synthetic temporal interaction stream with TGB-like
    statistics: Zipfian node popularity (hub nodes stress the dependency
    leveler), bipartite src/dst universes (tgbl-wiki is user->page),
    exponential inter-event times, and pre-generated fixed eval negatives
    for the splits in ``neg_splits``.
    """
    preset = SYNTHETIC_PRESETS.get(name, SYNTHETIC_PRESETS["tgbl-wiki-small"])
    E = num_edges or preset["num_edges"]
    N = num_nodes or preset["num_nodes"]
    F = msg_dim or preset["msg_dim"]
    M = num_neg or preset["num_neg"]

    seed_bytes = hashlib.sha256(f"{name}:{seed}".encode()).digest()[:8]
    rng = np.random.default_rng(int.from_bytes(seed_bytes, "little"))

    if bipartite:
        n_src = max(2, int(N * 0.85))
        n_dst = max(2, N - n_src)
    else:
        n_src = n_dst = N

    # Zipf-ish popularity over each universe.
    def zipf_choice(n, size):
        w = 1.0 / np.arange(1, n + 1) ** 0.9
        w /= w.sum()
        return rng.choice(n, size=size, p=w).astype(np.int32)

    src = zipf_choice(n_src, E)
    dst = zipf_choice(n_dst, E)
    if bipartite:
        dst = dst + n_src
    # Recurrence: ~40% of events repeat an earlier (src,dst) pair, like
    # interaction streams do.
    rep = rng.random(E) < 0.4
    rep_idx = rng.integers(0, E, size=E)
    keep = rep & (rep_idx < np.arange(E))
    src[keep] = src[rep_idx[keep]]
    dst[keep] = dst[rep_idx[keep]]

    t = np.cumsum(rng.exponential(1.0, size=E)).astype(np.float32)
    msg = rng.normal(0, 1, size=(E, F)).astype(np.float32)

    tr, va, te = chronological_masks(E)

    dst_universe = np.unique(dst)

    def gen_ns(mask):
        n_ev = int(mask.sum())
        pos = dst[mask]
        ns = rng.choice(dst_universe, size=(n_ev, M)).astype(np.int32)
        # avoid sampling the positive itself (TGB negatives exclude it)
        for _ in range(4):
            bad = ns == pos[:, None]
            if not bad.any():
                break
            ns[bad] = rng.choice(dst_universe, size=int(bad.sum()))
        return ns

    if "test" in neg_splits and "val" not in neg_splits:
        raise ValueError("the test negatives are drawn after the val ones: "
                         "ask for both")
    val_ns = gen_ns(va) if "val" in neg_splits else None
    test_ns = gen_ns(te) if "test" in neg_splits else None
    return Stream(name=name, src=src, dst=dst, t=t, msg=msg,
                  train_mask=tr, val_mask=va, test_mask=te,
                  val_ns=val_ns, test_ns=test_ns)
