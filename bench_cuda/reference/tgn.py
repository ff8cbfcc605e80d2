"""Plain PyTorch reference of the TGN step and of the streaming val pass:
the published math of TGN (Rossi et al. 2020) as the reference training
code runs it (TGL/tgb-tgn-dgl ``model_utils.py``: TimeEncode,
TemporalEdgePreprocess, EdgeGATConv with scalar messages, EdgePredictor;
the PyG ``memory_module.py`` GRU mailbox memory), in float32 with plain
torch operations, no kernel, no cache of the program and nothing
imported from it.  The stream state comes from ``stream_state.py``.

The embedding of a root slot (node r at block i) over its in-edges k:

    x_k   = drop(node features of the edge's source)   (ones when frozen)
    e_k   = drop(edge features) ⊕ drop(cos(w·Δt_k + b))
            (edge features ones on the self-loop)
    el'_k = Σ_d (W_n x_k + b_n)_{h,d} a_l[h,d]
            + Σ_d (W_e e_k + b_e)_{h,d} a_e[h,d]
    er    = Σ_d (W_n drop(x_r) + b_n)_{h,d} a_r[h,d]
    α_k   = softmax_k(leaky_relu(el'_k + er, 0.2)) · drop_attn
    emb   = drop(x_r) + mean_h Σ_k α_k el'_k

with dropout on the fc inputs (so the per-head sums over d fold into one
(in → H) projection, which is how it is computed here), and the predictor
out_fc(relu(src_fc(h_s) + dst_fc(h_d))), BCE over the positive and the
negative logit, and Adam (β 0.9, 0.999, ε 1e-8) written out.  With the
memory, every node of the batch's read set first applies its pending
mail: GRU(mem[node] ⊕ mem[partner] ⊕ msg ⊕ cos(w'·(t - last_update)),
mem[node]); the rows feed the embedding, and after the backward they
are written back and the batch's events become the new mail.

Dropout masks are drawn as the port draws them, so that the two sides
see the same masks: one ``torch.rand`` over the grid that the port hands
its step (R root slots, R >= T read off each step's device pack, the
rows past T padding), from a generator on the device seeded with
``mask_seed(seed)`` (the benchmark seeds the port's ``Engine.generator``
with the same), in the order source features, root features, edge
features, time encodings, attention; kept where the draw is below
1 - rate and scaled by 1 / (1 - rate).  The train check thus follows the
port's draw order, and not its padding.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .stream_state import (KIND_CACHE, KIND_INTRA, KIND_INVALID, KIND_SELF,
                           Grid, NegativeSampler, StreamState, batch_mail,
                           split_batches, split_blocks)


class Model(NamedTuple):
    """The sizes of TGN as a configuration states them."""

    D: int                 # gnn.dim_out (= memory.dim_out, time dim)
    H: int                 # gnn.att_head
    F: int                 # edge feature width
    K: int                 # sampling.neighbor
    P: int                 # train.max_intra_block
    memory: bool           # the GRU mailbox memory (else frozen ones)
    drop: float            # train.dropout
    att_drop: float        # train.att_dropout
    lr: float
    Dt: int = 100          # memory.dim_time


def model_of(config: dict, msg_dim: int) -> Model:
    """The reference's sizes from a configuration's TGL sections."""
    tgl = config["tgl"]
    s, mem, g, t = (tgl[k][0] for k in ("sampling", "memory", "gnn",
                                        "train"))
    return Model(D=g["dim_out"], H=g["att_head"], F=msg_dim,
                 K=s["neighbor"][0], P=t.get("max_intra_block", 32),
                 memory=not t.get("frozen_memory", True),
                 drop=t["dropout"], att_drop=t["att_dropout"],
                 lr=t["lr"], Dt=mem.get("dim_time", g["dim_time"]))


def layer_context(m: Model) -> dict:
    """TGN's sizes in the per-layer metrics' context: the padded grid's
    columns, the widths and the memory's form."""
    return {"Kp": m.K + 1 + m.P, "F": m.F, "D": m.D, "H": m.H,
            "memory": m.memory}


def leaf_shapes(m: Model) -> Dict[str, tuple]:
    """Every learnable leaf, by the name both sides give it."""
    D, H, F_ = m.D, m.H, m.F
    shapes = {
        "time.w": (D,), "time.b": (D,),
        "gat.attn_l": (H, D), "gat.attn_r": (H, D), "gat.attn_e": (H, D),
        "gat.fc_node.weight": (H * D, D), "gat.fc_node.bias": (H * D,),
        "gat.fc_edge.weight": (H * D, F_ + D), "gat.fc_edge.bias": (H * D,),
        "pred.src_fc.weight": (D, D), "pred.src_fc.bias": (D,),
        "pred.dst_fc.weight": (D, D), "pred.dst_fc.bias": (D,),
        "pred.out_fc.weight": (1, D), "pred.out_fc.bias": (1,),
    }
    if m.memory:
        msg = 2 * D + F_ + m.Dt
        shapes.update({
            "memory.time.w": (m.Dt,), "memory.time.b": (m.Dt,),
            "memory.cell.w_ih": (msg, 3 * D), "memory.cell.w_hh": (D, 3 * D),
            "memory.cell.b_ih": (3 * D,), "memory.cell.b_hh": (3 * D,)})
    return shapes


def make_weights(m: Model, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of a run, from ``seed``, on ``device``: one normal draw
    from a generator there, cut into the leaves and scaled as TGN's
    initialisers scale them (Xavier with the ReLU gain for the GAT and
    predictor matrices, 1/sqrt(fan-in) for biases and the GRU); the time
    encoders keep the published frequency ladder 1/10^linspace(0, 9)."""
    shapes = leaf_shapes(m)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 2654435761 % (2 ** 61) + 12345)
    flat = torch.randn(total, generator=gen, device=device)
    gain = math.sqrt(2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].reshape(shape)
        at += n
        if name.endswith("time.w"):
            ladder = 1.0 / 10 ** np.linspace(0, 9, shape[0])
            out[name] = torch.tensor(ladder, dtype=torch.float32,
                                     device=device)
            continue
        if name.endswith("time.b"):
            out[name] = torch.zeros(shape, device=device)
            continue
        if name.startswith("memory.cell"):
            scale = 1.0 / math.sqrt(m.D) / math.sqrt(3.0)
        elif len(shape) == 2:
            fan_out, fan_in = shape
            scale = gain * math.sqrt(2.0 / (fan_in + fan_out))
        else:
            scale = 1.0 / math.sqrt(shapes[name[:-len("bias")] + "weight"][1]
                                    if name.endswith("bias") else shape[0])
            scale /= math.sqrt(3.0)
        out[name] = (z * scale).contiguous()
    return out


def mask_seed(seed: int) -> int:
    """The seed of the dropout draws of a run of ``seed``."""
    return seed + 1


def step_record(pack) -> int:
    """The root slots of the grid a train step is handed (its device
    pack's ``root_loc``), over which its dropout is drawn."""
    return int(pack.root_loc.shape[0])


# ------------------------------------------------------------- the model
def time_encode(w, b, dt):
    return torch.cos(dt[..., None] * w + b)


def head_projection(weight, bias, attn):
    """(in → H) weights and (H,) bias of Σ_d (W x + b)_{h,d} a[h,d]."""
    H, D = attn.shape
    w = (weight.reshape(H, D, -1) * attn[:, :, None]).sum(dim=1)  # (H, in)
    return w.t(), (bias.reshape(H, D) * attn).sum(dim=1)


class Masks(NamedTuple):
    src: torch.Tensor
    dst: torch.Tensor
    edge: torch.Tensor
    time: torch.Tensor
    attn: torch.Tensor


def draw_masks(gen, R: int, Kp: int, m: Model, device) -> Masks:
    """The step's dropout draws over the padded grid, in the port's order:
    True where the value is kept."""
    def one(shape, rate):
        return torch.rand(shape, generator=gen, device=device) < 1.0 - rate
    return Masks(src=one((R, Kp, m.D), m.drop), dst=one((R, m.D), m.drop),
                 edge=one((R, Kp, m.F), m.drop),
                 time=one((R, Kp, m.D), m.drop),
                 attn=one((R, Kp, m.H), m.att_drop))


def embed(p, m: Model, kind, dt, feat, x_src, x_dst, feats,
          masks: Optional[Masks] = None) -> torch.Tensor:
    """Embeddings (T, D) of T root slots: ``kind``/``dt``/``feat`` (T, Kp)
    their grid, ``x_src`` (T, Kp, D) and ``x_dst`` (T, D) the node
    features, ``feats`` the (E, F) edge feature table; ``masks`` (rows
    already cut to T) in training."""
    valid = kind != KIND_INVALID
    is_edge = (kind == KIND_CACHE) | (kind == KIND_INTRA)
    ef = feats[feat] * is_edge[..., None]
    ef = torch.where((kind == KIND_SELF)[..., None], 1.0, ef)
    te = time_encode(p["time.w"], p["time.b"], dt)
    if masks is not None:
        keep = 1.0 - m.drop
        x_src = torch.where(masks.src, x_src / keep, 0.0)
        x_dst = torch.where(masks.dst, x_dst / keep, 0.0)
        ef = torch.where(masks.edge, ef / keep, 0.0)
        te = torch.where(masks.time, te / keep, 0.0)
    wl, bl = head_projection(p["gat.fc_node.weight"], p["gat.fc_node.bias"],
                             p["gat.attn_l"])
    wr, br = head_projection(p["gat.fc_node.weight"], p["gat.fc_node.bias"],
                             p["gat.attn_r"])
    we, be = head_projection(p["gat.fc_edge.weight"], p["gat.fc_edge.bias"],
                             p["gat.attn_e"])
    el = x_src @ wl + bl + torch.cat([ef, te], dim=-1) @ we + be   # (T,Kp,H)
    er = x_dst @ wr + br                                            # (T, H)
    logits = F.leaky_relu(el + er[:, None, :], 0.2)
    logits = logits.masked_fill(~valid[..., None], float("-inf"))
    alpha = torch.softmax(logits, dim=1)
    alpha = torch.nan_to_num(alpha, nan=0.0)      # a row with no edge
    if masks is not None:
        alpha = alpha * (masks.attn.to(torch.float32) / (1.0 - m.att_drop))
    out = (alpha * el).sum(dim=1)                                   # (T, H)
    return x_dst + out.mean(dim=-1, keepdim=True)


def predict(p, h_src, h_dst):
    s = h_src @ p["pred.src_fc.weight"].t() + p["pred.src_fc.bias"]
    d = h_dst @ p["pred.dst_fc.weight"].t() + p["pred.dst_fc.bias"]
    if d.dim() == 3:
        s = s[:, None, :]
    return (torch.relu(s + d) @ p["pred.out_fc.weight"].t()
            + p["pred.out_fc.bias"])[..., 0]


# ------------------------------------------------------------ the memory
class MemoryState:
    """The mailbox memory of every node (one mail slot), zero at a train
    epoch's start; ``mail_src`` is the node itself wherever a mail is."""

    def __init__(self, n: int, D: int, device):
        self.mem = torch.zeros((n, D), device=device)
        self.last_update = torch.zeros(n, device=device)
        self.mail_valid = torch.zeros(n, dtype=torch.bool, device=device)
        self.mail_dst = torch.zeros(n, dtype=torch.int64, device=device)
        self.mail_t = torch.zeros(n, device=device)
        self.mail_eid = torch.zeros(n, dtype=torch.int64, device=device)

    def clone(self) -> "MemoryState":
        out = MemoryState.__new__(MemoryState)
        for k in ("mem", "last_update", "mail_valid", "mail_dst", "mail_t",
                  "mail_eid"):
            setattr(out, k, getattr(self, k).clone())
        return out


def gru(p, x, h):
    gi = x @ p["memory.cell.w_ih"] + p["memory.cell.b_ih"]
    gh = h @ p["memory.cell.w_hh"] + p["memory.cell.b_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def apply_mail(p, st: MemoryState, nodes: torch.Tensor, feats):
    """The read set's memory rows with their pending mail applied, and
    their last-update times."""
    ok = st.mail_valid[nodes]
    h = st.mem[nodes]
    lu = st.last_update[nodes]
    msg = torch.cat([h, st.mem[st.mail_dst[nodes]], feats[st.mail_eid[nodes]],
                     time_encode(p["memory.time.w"], p["memory.time.b"],
                                 st.mail_t[nodes] - lu)], dim=-1)
    rows = torch.where(ok[:, None], gru(p, msg, h), h)
    return rows, torch.where(ok, st.mail_t[nodes], lu)


def commit(st: MemoryState, nodes, rows, lu, g: Grid, device) -> None:
    """Write the rows back, clear the read set's mail, post the batch's."""
    _commit(st, nodes, rows, lu, g.mail_node, g.mail_partner, g.mail_t,
            g.mail_eid, device)


@torch.no_grad()
def _commit(st: MemoryState, nodes, rows, lu, mail_node, mail_partner,
            mail_t, mail_eid, device) -> None:
    st.mem[nodes] = rows
    st.last_update[nodes] = lu
    st.mail_valid[nodes] = False
    wn = torch.as_tensor(mail_node, device=device)
    st.mail_valid[wn] = True
    st.mail_dst[wn] = torch.as_tensor(mail_partner, device=device)
    st.mail_t[wn] = torch.as_tensor(mail_t, device=device)
    st.mail_eid[wn] = torch.as_tensor(mail_eid, device=device)


def node_features(m: Model, g: Grid, rows, device):
    """(x_src (T, Kp, D), x_dst (T, D)) of a grid: the applied memory rows
    with the memory, ones when it is frozen (every column alike)."""
    T, Kp = g.kind.shape
    if not m.memory:
        return (torch.ones((T, Kp, m.D), device=device),
                torch.ones((T, m.D), device=device))
    loc = torch.as_tensor(g.nbr_loc, device=device)
    x_src = torch.where((loc >= 0)[..., None], rows[loc.clamp_min(0)], 0.0)
    return x_src, rows[torch.as_tensor(g.root_loc, device=device)]


def grid_tensors(g: Grid, device, rows=slice(None)):
    return (torch.as_tensor(g.kind[rows], device=device),
            torch.as_tensor(g.dt[rows], device=device),
            torch.as_tensor(g.feat[rows], device=device))


# -------------------------------------------------------- training steps
class TrainResult(NamedTuple):
    losses: List[float]
    grads: List[Dict[str, torch.Tensor]]    # each step's gradients
    params: Dict[str, torch.Tensor]          # after the last step


def train_steps(stream, m: Model, weights: Dict[str, torch.Tensor],
                seed: int, batch_size: int, records: List[int], device,
                half_batch: bool = False, still: bool = False
                ) -> TrainResult:
    """The first ``len(records)`` steps of a train epoch from
    ``weights``, a fresh stream state and fresh Adam moments, step i's
    dropout drawn over ``records[i]`` root slots (``step_record``).  Two
    planted faults: ``half_batch``, the loss is the mean over the first
    half of each batch's events only; ``still``, a step leaves the
    parameters and the memory as they were."""
    rows = np.nonzero(stream.train_mask)[0]
    src, dst, t = (stream.src.astype(np.int64), stream.dst.astype(np.int64),
                   stream.t)
    blocks = split_blocks(src, dst, rows, batch_size)
    batches = split_batches(rows, batch_size)
    sampler = NegativeSampler(np.unique(stream.dst), seed)
    Kp = m.K + 1 + m.P
    feats = torch.as_tensor(stream.msg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(mask_seed(seed))
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.items()}
    adam_m = {k: torch.zeros_like(v) for k, v in p.items()}
    adam_v = {k: torch.zeros_like(v) for k, v in p.items()}
    state = StreamState(stream.num_nodes, m.K)
    mem = MemoryState(stream.num_nodes, m.D, device) if m.memory else None
    losses, grads = [], []
    for step, R in enumerate(records):
        lo, hi = batches[step]
        r = rows[lo:hi]
        g = state.pack(src[r], dst[r], t[r], r, blocks[lo:hi],
                       sampler.sample(dst[r]), m.P, eval_mode=False,
                       with_mail=m.memory)
        T = len(g.root_node)
        if R < T:
            raise ValueError(f"step {step}: a grid of {R} root slots for "
                             f"{T} roots")
        masks = draw_masks(gen, R, Kp, m, device)
        masks = Masks(*(x[:T] for x in masks))
        nodes = rows_mem = lu = None
        if m.memory:
            nodes = torch.as_tensor(g.read_set, device=device)
            rows_mem, lu = apply_mail(p, mem, nodes, feats)
        x_src, x_dst = node_features(m, g, rows_mem, device)
        emb = embed(p, m, *grid_tensors(g, device), x_src, x_dst, feats,
                    masks)
        s_ = torch.as_tensor(g.ev_src_slot, device=device)
        pos = predict(p, emb[s_], emb[torch.as_tensor(g.ev_pos_slot,
                                                      device=device)])
        neg = predict(p, emb[s_], emb[torch.as_tensor(
            g.ev_neg_slot[:, 0], device=device)])
        if half_batch:
            pos, neg = pos[:len(pos) // 2], neg[:len(neg) // 2]
        loss = (F.binary_cross_entropy_with_logits(pos, torch.ones_like(pos))
                + F.binary_cross_entropy_with_logits(neg,
                                                     torch.zeros_like(neg)))
        names = list(p)
        gs = torch.autograd.grad(loss, [p[k] for k in names])
        if still:
            losses.append(float(loss.detach()))
            grads.append({k: gk.detach() for k, gk in zip(names, gs)})
            continue
        if m.memory:
            commit(mem, nodes, rows_mem.detach(), lu.detach(), g, device)
        with torch.no_grad():
            b1, b2, eps = 0.9, 0.999, 1e-8
            for k, gk in zip(names, gs):
                adam_m[k].mul_(b1).add_(gk, alpha=1 - b1)
                adam_v[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
                denom = adam_v[k].sqrt() / math.sqrt(c2) + eps
                p[k].addcdiv_(adam_m[k], denom, value=-m.lr / c1)
        losses.append(float(loss.detach()))
        grads.append({k: gk.detach() for k, gk in zip(names, gs)})
    return TrainResult(losses, grads, {k: v.detach() for k, v in p.items()})


# ------------------------------------------------------ the val pass
class ValResult(NamedTuple):
    mrr: float
    # (E_val, 2) per event: the negatives above its positive, and at or
    # above it; its rank is 1 + (sum of the two) / 2
    counts: np.ndarray
    taus: tuple
    # (E_val, len(taus), 4) per event and score slack tau: the negatives
    # counted with every one's score moved by up to tau max(1, |pos|):
    # (> pos + s, >= pos + s, > pos - s, >= pos - s)
    bounds: np.ndarray
    mem: Optional[MemoryState]
    state: StreamState


@torch.no_grad()
def train_epoch_state(stream, m: Model, seed: int, batch_size: int,
                      epochs: int = 1, params=None, device=None):
    """(stream state, memory) after ``epochs`` train epochs from a fresh
    state, with the port's sampler's negatives: the cache and the memory
    empty at each epoch's start, the clocks go on.  With the memory, the
    epochs run with ``params`` held fixed: per batch the read set applies
    its mail (``apply_mail``) and is written back with the batch's mail
    (``commit``), as a train step does before its Adam step; no
    gradient.  Without it the memory is None."""
    rows = np.nonzero(stream.train_mask)[0]
    src, dst = stream.src.astype(np.int64), stream.dst.astype(np.int64)
    t, N = stream.t, stream.num_nodes
    blocks = split_blocks(src, dst, rows, batch_size)
    sampler = NegativeSampler(np.unique(stream.dst), seed)
    state = StreamState(N, m.K)
    feats = torch.as_tensor(stream.msg, device=device) if m.memory else None
    mem = None
    for _ in range(epochs):
        state.reset_cache()
        mem = MemoryState(N, m.D, device) if m.memory else None
        for lo, hi in split_batches(rows, batch_size):
            r = rows[lo:hi]
            neg = sampler.sample(dst[r])
            if m.memory:
                nodes = torch.as_tensor(state.read_set(src[r], dst[r], neg),
                                        device=device)
                rows_mem, lu = apply_mail(params, mem, nodes, feats)
                node, partner, tm, eid = batch_mail(src[r], dst[r], t[r], r)
                _commit(mem, nodes, rows_mem, lu, node, partner,
                        tm.astype(np.float32), eid, device)
            state.advance_train(src[r], dst[r], t[r], r, blocks[lo:hi], neg)
    return state, mem


@torch.no_grad()
def val_pass(stream, m: Model, params, state: StreamState,
             mem: Optional[MemoryState], batch_size: int, device,
             taus: tuple = (), chunk: int = 16384) -> ValResult:
    """The streaming val pass at all M fixed negatives from ``state`` and
    ``mem`` (both advanced in place): per batch, every root slot embedded
    once, each event's positive ranked among its negatives by the TGB
    rule (rank = 1 + (#better + #at-least-as-good) / 2), the pass's MRR
    the mean of the batch means; per event its counts at each slack of
    ``taus``."""
    rows = np.nonzero(stream.val_mask)[0]
    src, dst = stream.src.astype(np.int64), stream.dst.astype(np.int64)
    blocks = split_blocks(src, dst, rows, batch_size)
    feats = torch.as_tensor(stream.msg, device=device)
    p = params
    means, counts, bounds = [], [], []
    for lo, hi in split_batches(rows, batch_size):
        r = rows[lo:hi]
        neg = stream.val_ns[lo:hi].astype(np.int64)
        g = state.pack(src[r], dst[r], stream.t[r], r, blocks[lo:hi], neg,
                       m.P, eval_mode=True, with_mail=m.memory)
        nodes = rows_mem = lu = None
        if m.memory:
            nodes = torch.as_tensor(g.read_set, device=device)
            rows_mem, lu = apply_mail(p, mem, nodes, feats)
        T = len(g.root_node)
        emb = torch.empty((T, m.D), device=device)
        for a in range(0, T, chunk):
            sl = slice(a, min(a + chunk, T))
            part = g._replace(nbr_loc=g.nbr_loc[sl], root_loc=g.root_loc[sl],
                              kind=g.kind[sl])
            x_src, x_dst = node_features(m, part, rows_mem, device)
            emb[sl] = embed(p, m, *grid_tensors(g, device, sl), x_src, x_dst,
                            feats)
        h_src = emb[torch.as_tensor(g.ev_src_slot, device=device)]
        pos = predict(p, h_src, emb[torch.as_tensor(g.ev_pos_slot,
                                                    device=device)])
        ns = torch.as_tensor(g.ev_neg_slot, device=device)
        slack = torch.tensor(taus, device=device)[None, :] * torch.clamp(
            pos.abs(), min=1.0)[:, None]                   # (B, taus)
        up, down = (pos[:, None] + slack)[..., None], (
            pos[:, None] - slack)[..., None]
        two = torch.zeros((len(r), 2), dtype=torch.int64, device=device)
        cnt = torch.zeros((len(r), len(taus), 4), dtype=torch.int64,
                          device=device)
        for a in range(0, ns.shape[1], 128):
            neg_s = predict(p, h_src, emb[ns[:, a:a + 128]])
            two += torch.stack([(neg_s > pos[:, None]).sum(dim=1),
                                (neg_s >= pos[:, None]).sum(dim=1)], dim=-1)
            if taus:
                n3 = neg_s[:, None, :]
                cnt += torch.stack([(n3 > up).sum(-1), (n3 >= up).sum(-1),
                                    (n3 > down).sum(-1),
                                    (n3 >= down).sum(-1)], dim=-1)
        bounds.append(cnt.cpu().numpy())
        rank = 0.5 * two.sum(dim=1).double() + 1.0
        means.append(float((1.0 / rank).mean()))
        counts.append(two.cpu().numpy())
        if m.memory:
            commit(mem, nodes, rows_mem, lu, g, device)
    return ValResult(float(np.mean(means)), np.concatenate(counts),
                     tuple(taus), np.concatenate(bounds), mem, state)


def program_state(mem: MemoryState, like):
    """The reference's memory laid out as the port's MemoryState ``like``
    (one mail slot; ``mail_src`` the node itself where a mail is; the
    rows past the reference's, the port's trash row, zero), on ``like``'s
    device and in its dtypes."""
    n = mem.mem.shape[0]
    node = torch.arange(n, device=mem.mem.device)
    values = {"mem": mem.mem, "last_update": mem.last_update,
              "mail_src": torch.where(mem.mail_valid, node, 0),
              "mail_dst": mem.mail_dst, "mail_t": mem.mail_t,
              "mail_eid": mem.mail_eid, "mail_valid": mem.mail_valid}
    out = {}
    for name, field in zip(like._fields, like):
        t = torch.zeros_like(field)
        t[:n] = values[name].reshape(t[:n].shape).to(t.device, t.dtype)
        out[name] = t
    return type(like)(**out)
