"""Temporal event-stream datasets: the port's copy of
tgb_tgn_dgl_tpu/data/dataset.py (``TemporalData``, ``load_npz``,
``chronological_masks``, the on-disk readers ``load_tgb`` (our npz or the
tgb package's processed directory) and ``load_tgl_data`` (the TGL
layout), and ``synthetic``).

Capability parity with the reference's L0/L1 data substrate: the TGB
``PyGLinkPropPredDataset`` + chronological mask split + fixed eval
negatives (reference utils.py:25-67), read from the canonical ``.npz``
container, or generated as deterministic synthetic streams with TGB-like
statistics (power-law degrees, recurrence) whose presets match the
published tgbl-* shapes.

All arrays are host numpy; device placement is the engine's concern.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# tgbl-* scale presets: (num_edges, num_nodes, msg_dim, num_eval_negatives)
# Edge counts from BASELINE.json / SURVEY.md §6; node counts and msg dims
# follow the TGB paper's dataset statistics (approximate where the exact
# value is irrelevant to throughput accounting).
SYNTHETIC_PRESETS: Dict[str, Dict] = {
    "tgbl-wiki": dict(num_edges=157_474, num_nodes=9_227, msg_dim=172, num_neg=999),
    "tgbl-review": dict(num_edges=4_730_000, num_nodes=352_637, msg_dim=1, num_neg=100),
    "tgbl-coin": dict(num_edges=22_809_486, num_nodes=638_486, msg_dim=1, num_neg=20),
    "tgbl-comment": dict(num_edges=44_314_507, num_nodes=994_790, msg_dim=2, num_neg=20),
    "tgbl-flight": dict(num_edges=67_169_570, num_nodes=18_143, msg_dim=16, num_neg=20),
    "tgbl-wiki-small": dict(num_edges=20_000, num_nodes=1_200, msg_dim=32, num_neg=32),
}


@dataclass
class TemporalData:
    """The full chronological event stream plus split masks and fixed eval
    negatives — the union of what reference ``getDataWithDependecyBlock``
    assembles (utils.py:25-67)."""

    name: str
    src: np.ndarray            # (E,) int32
    dst: np.ndarray            # (E,) int32
    t: np.ndarray              # (E,) float32 (cast as in temporal_dataset.py:42)
    msg: np.ndarray            # (E, F) float32 edge features
    train_mask: np.ndarray     # (E,) bool — chronological split
    val_mask: np.ndarray
    test_mask: np.ndarray
    val_ns: Optional[np.ndarray] = None    # (E_val, M) fixed negatives
    test_ns: Optional[np.ndarray] = None   # (E_test, M)
    eval_metric: str = "mrr"

    @property
    def num_nodes(self) -> int:
        return int(max(self.src.max(), self.dst.max())) + 1

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def msg_dim(self) -> int:
        return int(self.msg.shape[1])

    def unique_dst(self) -> np.ndarray:
        """Destination universe for train-time negative sampling
        (reference pyg-mem-tgn.py:39)."""
        return np.unique(self.dst)

    def split(self, which: str) -> "TemporalData":
        mask = {"train": self.train_mask, "val": self.val_mask,
                "test": self.test_mask}[which]
        return TemporalData(
            name=f"{self.name}/{which}",
            src=self.src[mask], dst=self.dst[mask], t=self.t[mask],
            msg=self.msg[mask],
            train_mask=np.ones(mask.sum(), bool),
            val_mask=np.zeros(mask.sum(), bool),
            test_mask=np.zeros(mask.sum(), bool),
            eval_metric=self.eval_metric,
        )

    def save_npz(self, path: str) -> None:
        arrays = dict(
            src=self.src, dst=self.dst, t=self.t, msg=self.msg,
            train_mask=self.train_mask, val_mask=self.val_mask,
            test_mask=self.test_mask,
            eval_metric=np.asarray(self.eval_metric),
        )
        if self.val_ns is not None:
            arrays["val_ns"] = self.val_ns
        if self.test_ns is not None:
            arrays["test_ns"] = self.test_ns
        np.savez_compressed(path, **arrays)


def load_npz(path: str, name: Optional[str] = None) -> TemporalData:
    try:
        z = np.load(path, allow_pickle=False)
        # only the *_ns members can be object arrays (ragged negative
        # sets, tools/convert_tgb.py) — probe just those, not the big
        # event/feature tables
        for k in ("val_ns", "test_ns"):
            if k in z.files:
                z[k]
    except ValueError:
        z = np.load(path, allow_pickle=True)
    return TemporalData(
        name=name or os.path.basename(path),
        src=z["src"].astype(np.int32),
        dst=z["dst"].astype(np.int32),
        t=z["t"].astype(np.float32),
        msg=z["msg"].astype(np.float32),
        train_mask=z["train_mask"].astype(bool),
        val_mask=z["val_mask"].astype(bool),
        test_mask=z["test_mask"].astype(bool),
        val_ns=z["val_ns"] if "val_ns" in z else None,
        test_ns=z["test_ns"] if "test_ns" in z else None,
        eval_metric=(str(z["eval_metric"]) if "eval_metric" in z.files
                     else "mrr"),
    )


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


def load_tgb(name: str, root: str = "datasets") -> TemporalData:
    """Load a TGB dataset from its on-disk layout (no ``tgb`` package, no
    network).  Accepts either our canonical npz (``<root>/<name>.npz`` or
    ``<root>/<dir>/data.npz``) or the TGB package's processed numpy files
    under ``<root>/<name with '-'→'_'>/``.
    """
    dirname = name.replace("-", "_")
    candidates = [
        os.path.join(root, f"{name}.npz"),
        os.path.join(root, dirname, "data.npz"),
        os.path.join(root, name, "data.npz"),
    ]
    for c in candidates:
        if os.path.exists(c):
            return load_npz(c, name=name)

    # TGB processed layout: ml_<name>.npy-style arrays saved by the tgb pkg.
    tgb_dir = os.path.join(root, dirname)
    if os.path.isdir(tgb_dir):
        data = _load_tgb_processed(name, tgb_dir)
        if data is not None:
            return data
    raise FileNotFoundError(
        f"No dataset found for '{name}' under '{root}'. Provide "
        f"'{name}.npz' (src/dst/t/msg/*_mask[/val_ns/test_ns]) or the TGB "
        f"processed directory, or use synthetic(name) for a synthetic "
        f"stream with matching statistics."
    )


def _load_tgb_processed(name: str, d: str) -> Optional[TemporalData]:
    """Reader for the tgb package's cached on-disk outputs (two known
    layouts; fixture-tested in tests/test_torch_ingest.py against the JAX
    package's reader).  The ROBUST path for real datasets is the
    repository's tools/convert_tgb.py (runs where the tgb
    package exists and emits our canonical npz with the exact arrays the
    reference assembles, utils.py:25-67, including the pre-generated
    negative sets this csv path cannot recover):

      1. TGAT/"ml_" layout (tgb's processed cache): ``ml_<name>.csv``
         with columns (,u,i,ts[,label,idx]) + ``ml_<name>.npy`` edge
         features (row 0 is a padding row — features are 1-indexed by
         ``idx``);
      2. edgelist csv (``*edgelist*.csv``) with named columns
         (timestamp|ts|time, src|source|u, dst|target|i|v,
         w*/feat* feature columns).
    """
    import csv as _csv

    files = sorted(os.listdir(d))
    # --- layout 1: ml_<name>.csv + ml_<name>.npy ----------------------
    ml_csv = [fn for fn in files
              if fn.startswith("ml_") and fn.endswith(".csv")]
    if ml_csv:
        fn = ml_csv[0]
        ss, ds, ts, idxs = [], [], [], []
        with open(os.path.join(d, fn)) as f:
            reader = _csv.DictReader(f)
            for row in reader:
                ss.append(int(float(row["u"])))
                ds.append(int(float(row["i"])))
                ts.append(float(row["ts"]))
                idxs.append(int(float(row.get("idx") or 0)))
        src = np.asarray(ss, np.int64)
        dst = np.asarray(ds, np.int64)
        t = np.asarray(ts, np.float32)
        feat_path = os.path.join(d, fn[:-4] + ".npy")
        table = np.load(feat_path) if os.path.exists(feat_path) else None
        idx = np.asarray(idxs, np.int64)
        if table is not None and not idx.any():
            # no idx column: features align row-for-row (1-indexed when
            # the table carries the padding row 0, else 0-indexed)
            idx = (np.arange(1, len(src) + 1)
                   if len(table) == len(src) + 1
                   else np.arange(len(src)))
        if (table is not None and len(idx) == len(src)
                and idx.min(initial=0) >= 0
                and idx.max(initial=0) < len(table)):
            msg = table[idx].astype(np.float32)
        else:
            if table is not None:
                import warnings
                warnings.warn(
                    f"{feat_path}: idx column out of range for the "
                    f"feature table; falling back to ones")
            msg = np.ones((len(src), 1), np.float32)
        if msg.ndim == 1:
            msg = msg[:, None]
        order = np.argsort(t, kind="stable")
        src, dst, t, msg = src[order], dst[order], t[order], msg[order]
        tr, va, te = chronological_masks(len(t))
        return TemporalData(name=name, src=src.astype(np.int32),
                            dst=dst.astype(np.int32), t=t, msg=msg,
                            train_mask=tr, val_mask=va, test_mask=te)

    # --- layout 2: *edgelist*.csv with named columns ------------------
    for fn in files:
        if fn.endswith(".csv") and "edgelist" in fn:
            ts, ss, ds, ws = [], [], [], []
            with open(os.path.join(d, fn)) as f:
                reader = _csv.DictReader(f)
                cols = reader.fieldnames or []
                for row in reader:
                    ts.append(float(row.get("timestamp") or row.get("ts") or row.get("time")))
                    ss.append(int(float(row.get("src") or row.get("source") or row.get("u"))))
                    ds.append(int(float(row.get("dst") or row.get("target") or row.get("i") or row.get("v"))))
                    feat_cols = [c for c in cols if c.startswith("w") or c.startswith("feat")]
                    ws.append([float(row[c]) for c in feat_cols] or [1.0])
            src = np.asarray(ss, np.int64)
            dst = np.asarray(ds, np.int64)
            # TGB maps dst into a disjoint id range; keep raw ids, remap dense.
            all_ids = np.concatenate([src, dst])
            uniq, inv = np.unique(all_ids, return_inverse=True)
            src = inv[: len(src)].astype(np.int32)
            dst = inv[len(src):].astype(np.int32)
            t = np.asarray(ts, np.float32)
            order = np.argsort(t, kind="stable")
            src, dst, t = src[order], dst[order], t[order]
            msg = np.asarray(ws, np.float32)[order]
            tr, va, te = chronological_masks(len(t))
            return TemporalData(name=name, src=src, dst=dst, t=t, msg=msg,
                                train_mask=tr, val_mask=va, test_mask=te)
    return None


def load_tgl_data(name: str, root: str = "DATA") -> "TemporalData":
    """Load a TGL-format dataset directory — the reference's legacy
    ``getData`` path (reference utils.py:71-97): ``<root>/<name>/`` with
    ``edges.npz`` (our npz) or ``edges.csv`` (src,dst,time[,...]).  The
    t-CSR ``ext_full.npz`` of that layout is not read here: the Engine
    builds the t-CSR of the stream itself under 'uniform' (data/tcsr.py,
    whose ``TCSR.load_npz`` reads such a file)."""
    d = os.path.join(root, name)
    npz = os.path.join(d, "edges.npz")
    if os.path.exists(npz):
        data = load_npz(npz, name=name)
    else:
        csv_path = os.path.join(d, "edges.csv")
        if not os.path.exists(csv_path):
            raise FileNotFoundError(
                f"no edges.npz/edges.csv under {d} (TGL layout)")
        import csv as _csv

        ss, ds, ts = [], [], []
        with open(csv_path) as f:
            for row in _csv.DictReader(f):
                ss.append(int(float(row.get("src") or row.get("u"))))
                ds.append(int(float(row.get("dst") or row.get("i")
                                    or row.get("v"))))
                ts.append(float(row.get("time") or row.get("ts")
                                or row.get("timestamp")))
        src = np.asarray(ss, np.int32)
        dst = np.asarray(ds, np.int32)
        t = np.asarray(ts, np.float32)
        tr, va, te = chronological_masks(len(t))
        data = TemporalData(name=name, src=src, dst=dst, t=t,
                            msg=np.ones((len(t), 1), np.float32),
                            train_mask=tr, val_mask=va, test_mask=te)
    return data


def synthetic(
    name: str = "tgbl-wiki-small",
    num_edges: Optional[int] = None,
    num_nodes: Optional[int] = None,
    msg_dim: Optional[int] = None,
    num_neg: Optional[int] = None,
    seed: int = 0,
    bipartite: bool = True,
) -> TemporalData:
    """Deterministic synthetic temporal interaction stream with TGB-like
    statistics: Zipfian node popularity (hub nodes stress the dependency
    leveler, SURVEY.md §7.4), bipartite src/dst universes (tgbl-wiki is
    user->page), bursty timestamps, and pre-generated fixed eval negatives
    (the role of TGB's load_val_ns/load_test_ns, reference utils.py:44-47).
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

    return TemporalData(
        name=name, src=src, dst=dst, t=t, msg=msg,
        train_mask=tr, val_mask=va, test_mask=te,
        val_ns=gen_ns(va), test_ns=gen_ns(te),
    )
