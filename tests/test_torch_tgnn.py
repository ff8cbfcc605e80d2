"""The port's TGNN (tgb_tgn_dgl_tpu_torch/models/tgnn.py) against the JAX
``tgnn_forward`` on the same Pack and bridged weights at dropout 0: the
(R, D) embeddings, the pos/neg logits, ``bce_loss`` and the gradient of
every parameter.

Tolerances (fp32 on both sides): 1e-5 abs+rel on embeddings, logits and
loss — the matmuls and the Kp-long softmax sums reduce in another order;
2e-5 abs + 1e-4 rel on gradients, which are sums over the whole (R, Kp)
grid."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgb_tgn_dgl_tpu.models.tgnn import (TGNNConfig as JaxTGNNConfig,
                                         bce_loss as jax_bce_loss,
                                         init_tgnn as jax_init_tgnn,
                                         tgnn_embed as jax_tgnn_embed,
                                         tgnn_forward as jax_tgnn_forward)
from tgb_tgn_dgl_tpu_torch.bridge import params_from_jax, params_to_jax
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
from tgb_tgn_dgl_tpu_torch.data.packer import (PackerConfig, StreamPacker,
                                               to_device)
from tgb_tgn_dgl_tpu_torch.models.tgnn import (TGNNConfig, bce_loss,
                                               init_tgnn, tgnn_embed,
                                               tgnn_forward)

F, D, H, K = 6, 16, 4, 5
TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4


def _packs(M):
    """Three train batches to fill the cache, then the pack under test
    (M negatives per event; M > 1 packs as an eval chunk)."""
    data = synthetic("tgbl-wiki-small", num_edges=500, num_nodes=60,
                     msg_dim=F, num_neg=M, seed=7)
    packer = StreamPacker(data.num_nodes, PackerConfig(
        num_neighbors=K, batch_size=80, max_intra_block=8))
    rng = np.random.default_rng(1)
    pack = None
    for i in range(4):
        rows = np.arange(80 * i, 80 * (i + 1))
        src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
        neg = rng.choice(data.unique_dst(), (80, M)).astype(np.int32)
        pack = packer.pack(src, dst, t, rows, get_block(src, dst),
                           neg[:, 0] if M == 1 else neg, eval_mode=M > 1)
    return data, pack


@pytest.mark.parametrize("M", [1, 3], ids=["train", "eval"])
@pytest.mark.parametrize("const_ones", [True, False],
                         ids=["frozen_ones", "memory_table"])
def test_forward_loss_and_grads_match_jax(M, const_ones):
    data, pack = _packs(M)
    jcfg = JaxTGNNConfig(edge_feat_dim=F, hidden_dim=D, num_heads=H,
                         feat_drop=0.0, attn_drop=0.0,
                         const_ones_memory=const_ones)
    tcfg = TGNNConfig(edge_feat_dim=F, hidden_dim=D, num_heads=H,
                      feat_drop=0.0, attn_drop=0.0,
                      const_ones_memory=const_ones)
    params = jax_init_tgnn(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(3)
    mem = (np.ones((data.num_nodes, D), np.float32) if const_ones
           else rng.normal(size=(data.num_nodes, D)).astype(np.float32))
    jpack = pack.device()

    def jloss(p):
        pos, neg = jax_tgnn_forward(p, jcfg, jnp.asarray(mem),
                                    jnp.asarray(data.msg), jpack,
                                    train=True)
        return jax_bce_loss(pos, neg, jpack.ev_valid), (pos, neg)

    (jl, (jpos, jneg)), jgrads = jax.value_and_grad(jloss,
                                                    has_aux=True)(params)
    jemb = jax_tgnn_embed(params, jcfg, jnp.asarray(mem),
                          jnp.asarray(data.msg), jpack, train=False)

    model = init_tgnn(tcfg)
    model.load_state_dict(params_from_jax(params))
    tpack = to_device(pack, "cpu")
    tmem = torch.from_numpy(mem)
    feats = torch.from_numpy(data.msg)
    pos, neg = tgnn_forward(model, tcfg, tmem, feats, tpack, train=True)
    loss = bce_loss(pos, neg, tpack.ev_valid)
    loss.backward()
    with torch.no_grad():
        emb = tgnn_embed(model, tcfg, tmem, feats, tpack, train=False)

    R = pack.root_nid.shape[0]
    assert emb.shape == (R, D)
    for name, a, b in (("embed", emb, jemb), ("pos", pos, jpos),
                       ("neg", neg, jneg), ("loss", loss, jl)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=TOL, atol=TOL, err_msg=name)
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()})

    def walk(g_port, g_jax, path):
        if isinstance(g_jax, dict):
            assert g_port.keys() == g_jax.keys(), path
            for k in g_jax:
                walk(g_port[k], g_jax[k], f"{path}/{k}")
            return
        np.testing.assert_allclose(g_port, np.asarray(g_jax),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=path)

    walk(grads, jgrads, "")


def test_local_read_matches_jax():
    """``local=True``: node features are the (U, D) rows of the batch's
    read set, gathered through ``nbr_loc``/``root_loc`` (the mailbox
    memory's read); the embedding, the logits and every gradient, the
    rows' own included, match the JAX ``local=True`` branch."""
    data, pack = _packs(3)
    jcfg = JaxTGNNConfig(edge_feat_dim=F, hidden_dim=D, num_heads=H,
                         feat_drop=0.0, attn_drop=0.0)
    tcfg = TGNNConfig(edge_feat_dim=F, hidden_dim=D, num_heads=H,
                      feat_drop=0.0, attn_drop=0.0)
    params = jax_init_tgnn(jax.random.PRNGKey(5), jcfg)
    U = pack.uniq_nid.shape[0]
    rows = np.random.default_rng(8).normal(size=(U, D)).astype(np.float32)
    jpack = pack.device()
    feats = jnp.asarray(data.msg)

    def jloss(p, r):
        pos, neg = jax_tgnn_forward(p, jcfg, r, feats, jpack, train=True,
                                    local=True)
        return jax_bce_loss(pos, neg, jpack.ev_valid)

    jl, (jgrads, jgrows) = jax.value_and_grad(jloss, argnums=(0, 1))(
        params, jnp.asarray(rows))
    jemb = jax_tgnn_embed(params, jcfg, jnp.asarray(rows), feats, jpack,
                          train=False, local=True)

    model = init_tgnn(tcfg)
    model.load_state_dict(params_from_jax(params))
    tpack = to_device(pack, "cpu")
    trows = torch.from_numpy(rows).requires_grad_(True)
    tfeats = torch.from_numpy(data.msg)
    pos, neg = tgnn_forward(model, tcfg, trows, tfeats, tpack, train=True,
                            local=True)
    loss = bce_loss(pos, neg, tpack.ev_valid)
    loss.backward()
    with torch.no_grad():
        emb = tgnn_embed(model, tcfg, trows, tfeats, tpack, train=False,
                         local=True)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(trows.grad.numpy(), np.asarray(jgrows),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    for part in ("gat", "pred"):
        for k, v in grads[part].items():
            want = jgrads[part][k]
            if isinstance(v, dict):
                for kk in v:
                    np.testing.assert_allclose(
                        v[kk], np.asarray(want[kk]), rtol=GRAD_RTOL,
                        atol=GRAD_ATOL, err_msg=f"{part}/{k}/{kk}")
            else:
                np.testing.assert_allclose(v, np.asarray(want),
                                           rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=f"{part}/{k}")

