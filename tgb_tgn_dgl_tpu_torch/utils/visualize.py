"""Debug visualization — capability parity with reference visualize.py:
the port's copy of tgb_tgn_dgl_tpu/utils/visualize.py.

The reference builds networkx Multi(Di)Graphs from sampled subgraphs
(`create_nx_multigraph`, visualize.py:16-73), renders them with curved
matplotlib edges to ``plots/`` (:83-129,166-218) and scatters TSNE'd
embeddings (:154-162).  Here the input is a numpy Pack (data/packer.py,
the batch container): every root slot's in-edges (cache / self / intra
kinds) become multigraph edges annotated with Δt and the edge-feature
row.

matplotlib/networkx/sklearn are imported lazily and every entry point
returns None when they are unavailable — plotting never becomes a
dependency of the package.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.packer import (KIND_CACHE, KIND_INTRA, KIND_SELF, Pack)

KIND_NAMES = {KIND_CACHE: "cache", KIND_INTRA: "intra", KIND_SELF: "self"}


def pack_to_networkx(pack: Pack, max_roots: Optional[int] = None,
                     include_self_loops: bool = False):
    """Build a networkx MultiDiGraph of a packed batch's message-passing
    structure (edges point neighbor → root, like the reference's
    in-edges).  Node labels are original node ids."""
    try:
        import networkx as nx
    except ImportError:
        return None
    g = nx.MultiDiGraph()
    R = pack.num_real_roots
    if max_roots is not None:
        R = min(R, max_roots)
    for r in range(R):
        root = int(pack.root_nid[r])
        g.add_node(root)
        for c in range(pack.nbr_kind.shape[1]):
            kind = int(pack.nbr_kind[r, c])
            if kind == 0:
                continue
            if kind == KIND_SELF and not include_self_loops:
                continue
            g.add_edge(int(pack.nbr_nid[r, c]), root,
                       kind=KIND_NAMES.get(kind, str(kind)),
                       dt=float(pack.nbr_dt[r, c]),
                       e_id=int(pack.nbr_feat[r, c]))
    return g


def visualize_pack(pack: Pack, path: str = "plots/batch.png",
                   max_roots: int = 40, seed: int = 0):
    """Render the batch multigraph with curved edges (reference
    visualize.py:83-129 style).  Returns the path or None if matplotlib
    or networkx is unavailable."""
    g = pack_to_networkx(pack, max_roots=max_roots)
    if g is None or g.number_of_nodes() == 0:
        return None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import networkx as nx
    except ImportError:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pos = nx.spring_layout(g, seed=seed)
    colors = {"cache": "#4878d0", "intra": "#d65f5f", "self": "#aaaaaa"}
    fig, ax = plt.subplots(figsize=(10, 8))
    nx.draw_networkx_nodes(g, pos, node_size=120, node_color="#eeeeee",
                           edgecolors="#333333", ax=ax)
    nx.draw_networkx_labels(g, pos, font_size=7, ax=ax)
    # curved parallel edges so multi-edges stay distinguishable
    for i, (u, v, k, d) in enumerate(g.edges(keys=True, data=True)):
        rad = 0.08 * (1 + k)
        nx.draw_networkx_edges(
            g, pos, edgelist=[(u, v)], connectionstyle=f"arc3,rad={rad}",
            edge_color=colors.get(d.get("kind"), "#444444"),
            width=0.8, alpha=0.7, arrowsize=7, ax=ax)
    ax.set_axis_off()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def visualize_embeddings(embeddings: np.ndarray,
                         labels: Optional[np.ndarray] = None,
                         path: str = "plots/embed.png", seed: int = 0):
    """TSNE scatter of embeddings (reference visualize.py:154-162)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE
    except ImportError:
        return None
    emb = np.asarray(embeddings)
    n = emb.shape[0]
    if n < 3:
        return None
    xy = TSNE(n_components=2, random_state=seed,
              perplexity=min(30, max(2, n // 4))).fit_transform(emb)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(xy[:, 0], xy[:, 1], s=12,
                    c=labels if labels is not None else "#4878d0",
                    cmap="viridis", alpha=0.8)
    if labels is not None:
        fig.colorbar(sc, ax=ax, shrink=0.8)
    ax.set_axis_off()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path
