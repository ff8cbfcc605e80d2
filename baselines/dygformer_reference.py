"""Plain reference of DyGFormer (Yu, Sun, Du and Lv, "Towards Better Dynamic
Graph Learning: New Architecture and Unified Library", NeurIPS 2023,
arXiv:2303.13047; its code is DyGLib, ``models/DyGFormer.py`` and
``models/modules.py``): its histories, its forward, its loss and Adam, in
float32 with plain torch and NumPy operations.  It imports nothing of
JAX, of the JAX package or of the port, calls no kernel and uses no
packer: every history is built from the raw event arrays with a list per
node.  The benchmark's copy of this file is
``bench_cuda/reference/dygformer.py`` (the two are held equal); the
functions near the end (``model_of`` .. ``train_steps``) are the
interface the benchmark's harness calls (``bench_cuda/reference/
__init__.py``).

Per scored pair (u, v) of an event at time t:

  1. history: each end w gets L tokens: w itself (edge row "none", Δt 0),
     then its L - 1 latest interactions earlier in the stream than the
     event, oldest first, each (other end, edge row, t - t_edge), then
     padding;
  2. co-occurrence: for every position of u's sequence, how often its
     node appears in u's sequence and how often in v's (v's sequence
     alike); padding counts 0.  Each count c maps to
     Linear(C→C)(ReLU(Linear(1→C)(c))); the two count channels are summed;
  3. four channels of width C, each a Linear of a patch of ``patch``
     tokens' features: the node's raw features (zero rows of the node
     feature width: the stream has none), the edge features (zero for the
     end itself and for padding), cos(w·Δt + b) (zero at padding) and the
     co-occurrence encoding;
  4. u's tokens then v's, the channels concatenated (node, edge, time,
     co-occurrence): width D = 4C;
  5. ``layers`` pre-LayerNorm Transformer layers, with no attention mask:
     x += drop(MHA(LN(x))) (dropout on the attention probabilities, the
     query scaled by 1/sqrt(head width) before its product with the
     keys), x += drop(W2 drop(GELU(W1 LN(x)))) with W1 of width 4D;
  6. the mean over each end's tokens, then Linear(D→node width): h_u, h_v;
  7. the logit fc2(ReLU(fc1([h_u ‖ h_v]))) (DyGLib's ``MergeLayer``);
  8. the loss: binary cross-entropy, the mean over the positive and the
     negative logits of the batch's events; Adam (β 0.9, 0.999, ε 1e-8),
     written out.

Departures from DyGLib:

  * a history is the interactions earlier in the stream (row order),
    where DyGLib takes strictly earlier timestamps: events that tie in
    time see each other in stream order;
  * every end is padded to L tokens, where DyGLib pads each call to its
    longest history: the two agree whenever some end of the call has
    L - 1 or more earlier interactions (padding takes part in the
    attention, so it changes the numbers where they do not);
  * the loss is computed from the logits (DyGLib's ``BCELoss`` takes
    sigmoid probabilities and clamps their logarithms at -100);
  * node ids start at 0 and padding is marked by validity (DyGLib keeps a
    zero row 0 for padding; the features read are the same zeros);
  * the negatives are the port's train sampler's (uniform over the
    destination universe, a draw equal to the positive drawn again);
    the weights come from one normal draw of the seed (``make_weights``).

Dropout masks are drawn as the port draws them, so that both sides see
the same masks: per layer, in the order attention probabilities
(P, heads, 2T, 2T), attention output (P, 2T, D), feed-forward hidden
(P, 2T, 4D) and feed-forward output (P, 2T, D), one ``torch.rand`` each
over the step's padded pair grid (P = B_pad (1 + M) pairs: each event
against its positive, then against each negative; ``step_record``), from
a generator on the device seeded with ``mask_seed(seed)``; kept where the
draw is below 1 - rate and scaled by 1 / (1 - rate).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


class Model(NamedTuple):
    """DyGFormer's sizes."""

    node_dim: int          # node feature width (DyGLib's 172)
    edge_dim: int          # the stream's edge feature width
    time_dim: int          # time encoding width
    C: int                 # channel width
    patch: int             # tokens a patch
    L: int                 # tokens of an end's sequence
    layers: int            # Transformer layers
    heads: int             # attention heads
    drop: float            # dropout
    att_drop: float        # attention dropout
    lr: float


def model_of(config: dict, msg_dim: int) -> Model:
    """The sizes from a configuration's TGL sections (``gnn`` and
    ``train``) and the stream's edge feature width."""
    g, t = config["tgl"]["gnn"][0], config["tgl"]["train"][0]
    return Model(node_dim=g["node_feat_dim"], edge_dim=msg_dim,
                 time_dim=g["dim_time"], C=g["channel_embedding_dim"],
                 patch=g["patch_size"], L=g["max_input_sequence_length"],
                 layers=g["layer"], heads=g["att_head"], drop=t["dropout"],
                 att_drop=t["att_dropout"], lr=t["lr"])


def layer_context(m: Model) -> dict:
    """The model's sizes in the per-layer metrics' context."""
    return {"L": m.L, "patch": m.patch, "channel_width": m.C,
            "layers": m.layers, "heads": m.heads, "node_dim": m.node_dim,
            "F": m.edge_dim, "time_dim": m.time_dim}


def leaf_shapes(m: Model) -> Dict[str, tuple]:
    """Every learnable leaf, by the name both sides give it."""
    C, D, p = m.C, 4 * m.C, m.patch
    shapes = {
        "time.w": (m.time_dim,), "time.b": (m.time_dim,),
        "cooc.fc1.weight": (C, 1), "cooc.fc1.bias": (C,),
        "cooc.fc2.weight": (C, C), "cooc.fc2.bias": (C,),
        "proj.node.weight": (C, p * m.node_dim), "proj.node.bias": (C,),
        "proj.edge.weight": (C, p * m.edge_dim), "proj.edge.bias": (C,),
        "proj.time.weight": (C, p * m.time_dim), "proj.time.bias": (C,),
        "proj.cooc.weight": (C, p * C), "proj.cooc.bias": (C,)}
    for i in range(m.layers):
        pre = f"layers.{i}."
        shapes.update({
            pre + "norm1.weight": (D,), pre + "norm1.bias": (D,),
            pre + "qkv.weight": (3 * D, D), pre + "qkv.bias": (3 * D,),
            pre + "out.weight": (D, D), pre + "out.bias": (D,),
            pre + "norm2.weight": (D,), pre + "norm2.bias": (D,),
            pre + "fc1.weight": (4 * D, D), pre + "fc1.bias": (4 * D,),
            pre + "fc2.weight": (D, 4 * D), pre + "fc2.bias": (D,)})
    shapes.update({
        "output.weight": (m.node_dim, D), "output.bias": (m.node_dim,),
        "pred.fc1.weight": (m.node_dim, 2 * m.node_dim),
        "pred.fc1.bias": (m.node_dim,),
        "pred.fc2.weight": (1, m.node_dim), "pred.fc2.bias": (1,)})
    return shapes


def make_weights(m: Model, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of a run, from ``seed``, on ``device``: one normal draw
    from a generator there, cut into the leaves, each matrix and its bias
    scaled to the spread of torch's default init (1/sqrt(3 fan-in)); the
    time encoder keeps its frequency ladder 1/10^linspace(0, 9) and zero
    phase, and LayerNorm its ones and zeros plus a twentieth of the
    draw."""
    shapes = leaf_shapes(m)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 2654435761 % (2 ** 61) + 54321)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].reshape(shape)
        at += n
        if name == "time.w":
            ladder = 1.0 / 10 ** np.linspace(0, 9, shape[0])
            out[name] = torch.tensor(ladder, dtype=torch.float32,
                                     device=device)
        elif name == "time.b":
            out[name] = torch.zeros(shape, device=device)
        elif ".norm" in name:
            base = 1.0 if name.endswith("weight") else 0.0
            out[name] = (base + 0.05 * z).contiguous()
        else:
            w = shapes[name[:-len("bias")] + "weight"] if name.endswith(
                "bias") else shape
            out[name] = (z / math.sqrt(3.0 * w[1])).contiguous()
    return out


# ------------------------------------------------------------ histories
class Histories:
    """Every node's interactions so far, in stream order: a list per node
    of (other end, edge row, time)."""

    def __init__(self, num_nodes: int):
        self.of = [[] for _ in range(num_nodes)]

    def add(self, src: int, dst: int, row: int, t) -> None:
        self.of[src].append((dst, row, np.float32(t)))
        self.of[dst].append((src, row, np.float32(t)))

    def sequence(self, w: int, t, L: int):
        """w's L tokens at an event of time ``t``: (ids, edge rows, Δt,
        valid), each (L,); the edge row of w itself and of padding is -1,
        the id of padding -1."""
        last = self.of[w][-(L - 1):]
        ids = np.full(L, -1, np.int64)
        eid = np.full(L, -1, np.int64)
        dt = np.zeros(L, np.float32)
        ok = np.zeros(L, bool)
        ids[0], ok[0] = w, True
        for j, (other, row, te) in enumerate(last, start=1):
            ids[j], eid[j], ok[j] = other, row, True
            dt[j] = np.float32(t) - te
        return ids, eid, dt, ok


def batch_sequences(hist: Histories, src, dst, t, rows, neg, L: int):
    """(ids, edge rows, Δt, valid), each (n, 2 + M, L), of every end (src,
    dst, then each negative) of n events in stream order, each event's
    read before it joins the histories."""
    n = len(src)
    neg = np.asarray(neg).reshape(n, -1)
    E = 2 + neg.shape[1]
    out = [np.empty((n, E, L), d) for d in (np.int64, np.int64, np.float32,
                                            bool)]
    for i in range(n):
        ends = [int(src[i]), int(dst[i])] + [int(x) for x in neg[i]]
        for e, w in enumerate(ends):
            for o, a in zip(out, hist.sequence(w, t[i], L)):
                o[i, e] = a
        hist.add(int(src[i]), int(dst[i]), int(rows[i]), t[i])
    return out


def pair_ends(x: torch.Tensor):
    """(u, v) of every pair from (n, E, ...) per end: the pairs run over the
    other end first: (src, dst) of every event, then (src, negative j)."""
    n, E = x.shape[:2]
    u = torch.cat([x[:, 0]] * (E - 1))
    v = torch.cat([x[:, j] for j in range(1, E)])
    return u, v


def cooccurrence(a, a_ok, b, b_ok) -> torch.Tensor:
    """(P, L, 2): per position of ``a``, how often its node appears among
    the valid positions of ``a`` and of ``b``; 0 at ``a``'s padding."""
    counts = []
    for seq, ok in ((a, a_ok), (b, b_ok)):
        same = (a[:, :, None] == seq[:, None, :]) & ok[:, None, :]
        counts.append(same.sum(dim=-1).to(torch.float32))
    c = torch.stack(counts, dim=-1)
    return torch.where(a_ok[..., None], c, 0.0)


# ------------------------------------------------------------ the model
def draw_masks(gen, P: int, m: Model, device) -> List[List[torch.Tensor]]:
    """The step's dropout draws over P padded pairs, in the port's order:
    per layer, attention probabilities, attention output, feed-forward
    hidden, feed-forward output; True where the value is kept."""
    T2, D = 2 * m.L // m.patch, 4 * m.C

    def one(shape, rate):
        return torch.rand(shape, generator=gen, device=device) < 1.0 - rate
    return [[one((P, m.heads, T2, T2), m.att_drop), one((P, T2, D), m.drop),
             one((P, T2, 4 * D), m.drop), one((P, T2, D), m.drop)]
            for _ in range(m.layers)]


def _drop(x, keep_mask, rate):
    if keep_mask is None:
        return x
    return torch.where(keep_mask, x / (1.0 - rate), 0.0)


def _patched(x, patch):
    P, L, F_ = x.shape
    return x.reshape(P, L // patch, patch * F_)


def _linear(p, name, x):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def pair_logits(p, m: Model, seqs, feats, masks=None) -> torch.Tensor:
    """The logit of every pair of n events' sequences ``seqs`` ((ids, edge
    rows, Δt, valid) as ``batch_sequences`` gives them, on the device):
    P = n (E - 1) logits, pairs as ``pair_ends`` orders them; ``masks``
    (cut to the P pairs) in training."""
    ids, eid, dt, ok = seqs
    u_ids, v_ids = pair_ends(ids)
    u_eid, v_eid = pair_ends(eid)
    u_dt, v_dt = pair_ends(dt)
    u_ok, v_ok = pair_ends(ok)
    P, L = u_ids.shape
    pt = m.patch

    def channels(ids_, eid_, dt_, ok_, co):
        node = torch.zeros((P, L, m.node_dim), device=ids_.device)
        edge = torch.where((eid_ >= 0)[..., None],
                           feats[eid_.clamp_min(0)], 0.0)
        time = torch.cos(dt_[..., None] * p["time.w"] + p["time.b"])
        time = torch.where(ok_[..., None], time, 0.0)
        enc = _linear(p, "cooc.fc2", torch.relu(_linear(
            p, "cooc.fc1", co[..., None]))).sum(dim=-2)
        return [_linear(p, "proj.node", _patched(node, pt)),
                _linear(p, "proj.edge", _patched(edge, pt)),
                _linear(p, "proj.time", _patched(time, pt)),
                _linear(p, "proj.cooc", _patched(enc, pt))]

    cu = channels(u_ids, u_eid, u_dt, u_ok,
                  cooccurrence(u_ids, u_ok, v_ids, v_ok))
    cv = channels(v_ids, v_eid, v_dt, v_ok,
                  cooccurrence(v_ids, v_ok, u_ids, u_ok))
    x = torch.cat([torch.cat([a, b], dim=1) for a, b in zip(cu, cv)],
                  dim=-1)                                   # (P, 2T, D)
    D = x.shape[-1]
    dh = D // m.heads
    T2 = x.shape[1]
    for i in range(m.layers):
        pre = f"layers.{i}."
        mk = masks[i] if masks is not None else [None] * 4
        h = F.layer_norm(x, (D,), p[pre + "norm1.weight"],
                         p[pre + "norm1.bias"])
        q, k, v = _linear(p, pre + "qkv", h).split(D, dim=-1)
        q, k, v = (z.reshape(P, T2, m.heads, dh).transpose(1, 2)
                   for z in (q, k, v))
        att = torch.softmax((q * math.sqrt(1.0 / dh)) @ k.transpose(-1, -2),
                            dim=-1)
        att = _drop(att, mk[0], m.att_drop)
        o = (att @ v).transpose(1, 2).reshape(P, T2, D)
        x = x + _drop(_linear(p, pre + "out", o), mk[1], m.drop)
        h = F.gelu(_linear(p, pre + "fc1", F.layer_norm(
            x, (D,), p[pre + "norm2.weight"], p[pre + "norm2.bias"])))
        h = _linear(p, pre + "fc2", _drop(h, mk[2], m.drop))
        x = x + _drop(h, mk[3], m.drop)
    T = T2 // 2
    h_u = _linear(p, "output", x[:, :T].mean(dim=1))
    h_v = _linear(p, "output", x[:, T:].mean(dim=1))
    hid = torch.relu(_linear(p, "pred.fc1", torch.cat([h_u, h_v], dim=-1)))
    return _linear(p, "pred.fc2", hid)[:, 0]


def sequences_on(seqs, device):
    return [torch.as_tensor(a, device=device) for a in seqs]


class NegativeSampler:
    """Train negatives as the port draws them: uniform over the
    destination universe, a draw equal to the positive drawn again, from
    a numpy PCG64 stream of ``seed``."""

    def __init__(self, dst_nodes: np.ndarray, seed: int):
        self.dst_nodes = np.asarray(dst_nodes)
        self.rng = np.random.default_rng(seed)

    def sample(self, pos_dst: np.ndarray) -> np.ndarray:
        n = len(pos_dst)
        out = self.dst_nodes[self.rng.integers(0, len(self.dst_nodes), n)]
        for _ in range(64):
            bad = out == pos_dst
            nb = int(bad.sum())
            if nb == 0:
                break
            out[bad] = self.dst_nodes[
                self.rng.integers(0, len(self.dst_nodes), nb)]
        return out.astype(np.int64)


def split_batches(n_rows: int, batch_size: int):
    return [(lo, min(lo + batch_size, n_rows))
            for lo in range(0, n_rows, batch_size)]


# ------------------------------------------------------ the interface
def mask_seed(seed: int) -> int:
    """The seed of the dropout draws of a run of ``seed``."""
    return seed + 1


def step_record(pack) -> int:
    """The padded events of a train step's history wire: its pair grid,
    over which its dropout is drawn, is that many times 1 + M."""
    return int(pack.ev_end.shape[0])


class TrainResult(NamedTuple):
    losses: List[float]
    grads: List[Dict[str, torch.Tensor]]    # each step's gradients
    params: Dict[str, torch.Tensor]          # after the last step


def train_steps(stream, m: Model, weights: Dict[str, torch.Tensor],
                seed: int, batch_size: int, records: List[int], device,
                half_batch: bool = False, still: bool = False
                ) -> TrainResult:
    """The first ``len(records)`` steps of a train epoch from ``weights``,
    empty histories and fresh Adam moments, step i's dropout drawn over
    ``records[i]`` padded events (``step_record``).  Two planted faults:
    ``half_batch``, the loss is the mean over the first half of each
    batch's events only; ``still``, a step leaves the parameters as they
    were."""
    rows = np.nonzero(stream.train_mask)[0]
    src, dst, t = (stream.src.astype(np.int64), stream.dst.astype(np.int64),
                   stream.t)
    sampler = NegativeSampler(np.unique(stream.dst), seed)
    hist = Histories(stream.num_nodes)
    feats = torch.as_tensor(stream.msg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(mask_seed(seed))
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.items()}
    adam_m = {k: torch.zeros_like(v) for k, v in p.items()}
    adam_v = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grads = [], []
    for step, (lo, hi) in enumerate(split_batches(len(rows),
                                                  batch_size)[:len(records)]):
        r = rows[lo:hi]
        n, Bp = len(r), records[step]
        if Bp < n:
            raise ValueError(f"step {step}: a wire of {Bp} events for {n}")
        neg = sampler.sample(dst[r])
        seqs = sequences_on(batch_sequences(hist, src[r], dst[r], t[r], r,
                                            neg, m.L), device)
        keep = torch.cat([torch.arange(n), Bp + torch.arange(n)]).to(device)
        masks = [[x[keep] for x in layer]
                 for layer in draw_masks(gen, 2 * Bp, m, device)]
        logits = pair_logits(p, m, seqs, feats, masks)
        pos, neg_l = logits[:n], logits[n:]
        if half_batch:
            pos, neg_l = pos[:n // 2], neg_l[:n // 2]
        loss = F.binary_cross_entropy_with_logits(
            torch.cat([pos, neg_l]),
            torch.cat([torch.ones_like(pos), torch.zeros_like(neg_l)]))
        names = list(p)
        gs = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        grads.append({k: gk.detach() for k, gk in zip(names, gs)})
        if still:
            continue
        with torch.no_grad():
            b1, b2, eps = 0.9, 0.999, 1e-8
            for k, gk in zip(names, gs):
                adam_m[k].mul_(b1).add_(gk, alpha=1 - b1)
                adam_v[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
                denom = adam_v[k].sqrt() / math.sqrt(c2) + eps
                p[k].addcdiv_(adam_m[k], denom, value=-m.lr / c1)
    return TrainResult(losses, grads, {k: v.detach() for k, v in p.items()})


@torch.no_grad()
def val_pass(stream, m: Model, params, hist: Histories, neg_table,
             batch_size: int, device, pair_chunk: int = 4096) -> float:
    """The streaming val pass from ``hist`` (advanced in place): per batch
    every event ranked among its fixed negatives ``neg_table`` (E_val, M)
    by the TGB rule (rank = 1 + (#better + #at-least-as-good) / 2); the
    MRR, the mean of the batch means."""
    rows = np.nonzero(stream.val_mask)[0]
    src, dst, t = (stream.src.astype(np.int64), stream.dst.astype(np.int64),
                   stream.t)
    feats = torch.as_tensor(stream.msg, device=device)
    means = []
    for lo, hi in split_batches(len(rows), batch_size):
        r = rows[lo:hi]
        neg = np.asarray(neg_table[lo:hi])
        seqs = batch_sequences(hist, src[r], dst[r], t[r], r, neg, m.L)
        E = seqs[0].shape[1]
        per = max(1, pair_chunk // (E - 1))
        logits = []
        for a in range(0, len(r), per):
            part = sequences_on([s[a:a + per] for s in seqs], device)
            logits.append(pair_logits(params, m, part, feats).reshape(
                E - 1, -1).t())
        sc = torch.cat(logits)                          # (n, 1 + M)
        pos, negs = sc[:, :1], sc[:, 1:]
        rank = 1.0 + 0.5 * ((negs > pos).sum(1) + (negs >= pos).sum(1))
        means.append(float((1.0 / rank.double()).mean()))
    return float(np.mean(means))


def train_histories(stream, n_events: Optional[int] = None) -> Histories:
    """The histories after a train epoch (or its first ``n_events``
    events): the train split's events in stream order."""
    rows = np.nonzero(stream.train_mask)[0][:n_events]
    hist = Histories(stream.num_nodes)
    for r in rows:
        hist.add(int(stream.src[r]), int(stream.dst[r]), int(r),
                 stream.t[r])
    return hist
