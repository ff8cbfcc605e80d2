"""The port's decoder heads (tgb_tgn_dgl_tpu_torch/models/decoders.py)
against tgb_tgn_dgl_tpu/models/decoders.py on the same seeded numpy
inputs, with bridged parameters, on the CPU.

  * ``LinkPredictor`` with (B, D) and (B, M, D) destinations and
    ``NodePredictor``: 1e-6 abs+rel (two small matmuls);
  * ``ConvTransE`` in eval mode, and in train mode at dropout 0 (the batch
    statistics), scores within 1e-5 abs+rel (a conv, a C·D-long fc sum and
    a D-long inner product per score, reduced in another order); the
    three batch norms' running statistics after two train calls within
    1e-6 (the JAX package updates the running variance with the biased
    batch variance; ``nn.BatchNorm1d`` would take the unbiased one); the
    gradient of every ConvTransE parameter within 1e-4 abs+rel (sums over
    the batch and the positions; the batch norms' backward divides by the
    batch's standard deviation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgb_tgn_dgl_tpu.models import decoders as jd
from tgb_tgn_dgl_tpu_torch.bridge import (conv_transe_state_from_jax,
                                          params_from_jax, params_to_jax)
from tgb_tgn_dgl_tpu_torch.models import decoders as td

TOL = 1e-6
SCORE_TOL = 1e-5
GRAD_TOL = 1e-4
B, M, D = 12, 5, 16
DROP0 = dict(input_drop=0.0, hidden_drop=0.0, feature_drop=0.0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dst_shape", [(B, D), (B, M, D)], ids=["BD", "BMD"])
def test_link_predictor_matches_jax(dst_shape):
    params = jd.init_link_predictor(jax.random.PRNGKey(0), D, hidden=24)
    z_src, z_dst = _normal(1, B, D), _normal(2, *dst_shape)
    want = jd.link_predictor(params, jnp.asarray(z_src), jnp.asarray(z_dst))
    mod = td.LinkPredictor(D, hidden=24)
    mod.load_state_dict(params_from_jax(params))
    got = mod(_t(z_src), _t(z_dst))
    assert tuple(got.shape) == dst_shape[:-1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_node_predictor_matches_jax():
    params = jd.init_node_predictor(jax.random.PRNGKey(3), D, 7)
    z = _normal(4, B, D)
    mod = td.NodePredictor(D, 7)
    mod.load_state_dict(params_from_jax(params))
    got = mod(_t(z))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jd.node_predictor(params,
                                                            jnp.asarray(z))),
                               rtol=TOL, atol=TOL)


def _conv_transe(channels=6, ks=3, seed=5):
    """Both ConvTransEs from one JAX init, with batch-norm parameters and
    running statistics moved off their init values, so each leaf is
    exercised."""
    params, state = jd.init_conv_transe(jax.random.PRNGKey(seed), D,
                                        channels, ks)
    rng = np.random.default_rng(seed)
    for bn in ("bn0", "bn1", "bn2"):
        n = params[bn]["scale"].shape[0]
        params[bn]["scale"] = jnp.asarray(1 + 0.1 * rng.normal(size=n),
                                          jnp.float32)
        params[bn]["bias"] = jnp.asarray(0.1 * rng.normal(size=n),
                                         jnp.float32)
    state = jd.ConvTransEState(*(
        jd.BNState(mean=jnp.asarray(0.1 * rng.normal(size=s.mean.shape),
                                    jnp.float32),
                   var=jnp.asarray(rng.uniform(0.5, 2.0, s.var.shape),
                                   jnp.float32))
        for s in state))
    params["conv_b"] = jnp.asarray(0.1 * rng.normal(size=channels),
                                   jnp.float32)
    mod = td.ConvTransE(D, channels, ks)
    mod.load_state_dict({**params_from_jax(params),
                         **conv_transe_state_from_jax(state)})
    return params, state, mod


def _inputs(seed, n_ent=30):
    return _normal(seed, n_ent, D), _normal(seed + 1, B, D), \
        _normal(seed + 2, B, D)


@pytest.mark.parametrize("ks", [3, 5], ids=["ks3", "ks5"])
def test_conv_transe_eval_matches_jax(ks):
    params, state, mod = _conv_transe(ks=ks)
    ent, sub, rel = _inputs(10)
    want, new = jd.conv_transe(params, state, jnp.asarray(ent),
                               jnp.asarray(sub), jnp.asarray(rel),
                               train=False)
    got = mod(_t(ent), _t(sub), _t(rel), train=False)
    assert tuple(got.shape) == (B, 30)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    # eval mode leaves the running statistics alone
    for name, buf in mod.named_buffers():
        np.testing.assert_array_equal(
            buf.numpy(), conv_transe_state_from_jax(state)[name].numpy())


def test_conv_transe_train_and_bn_state_match_jax():
    """Two train calls at dropout 0: the scores of each (batch
    statistics) and the three batch norms' running mean and variance
    after both."""
    params, state, mod = _conv_transe()
    for seed in (20, 30):
        ent, sub, rel = _inputs(seed)
        want, state = jd.conv_transe(params, state, jnp.asarray(ent),
                                     jnp.asarray(sub), jnp.asarray(rel),
                                     train=True, **DROP0)
        got = mod(_t(ent), _t(sub), _t(rel), train=True, **DROP0)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
    want_state = conv_transe_state_from_jax(state)
    assert set(want_state) == {n for n, _ in mod.named_buffers()}
    for name, buf in mod.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_state[name].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
    # the running variance moved toward the biased batch variance: an
    # unbiased update would sit off it by var·(n/(n-1) - 1)·momentum
    assert not torch.equal(mod.bn2.var, torch.ones(D))


def test_conv_transe_grads_match_jax():
    """d/d(every parameter) of Σ scores·C in train mode at dropout 0."""
    params, state, mod = _conv_transe(seed=7)
    ent, sub, rel = _inputs(40)
    c = _normal(50, B, 30)

    def jscalar(p):
        s, _ = jd.conv_transe(p, state, jnp.asarray(ent), jnp.asarray(sub),
                              jnp.asarray(rel), train=True, **DROP0)
        return jnp.sum(s * c)

    jgrads = jax.grad(jscalar)(params)
    (mod(_t(ent), _t(sub), _t(rel), train=True, **DROP0) * _t(c)).sum() \
        .backward()
    got = params_to_jax({n: p.grad for n, p in mod.named_parameters()})
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(list(mod.parameters()))
    for path, want in flat:
        node = got
        for k in path:
            node = node[k.key]
        want = np.asarray(want)
        assert node.shape == want.shape, path
        np.testing.assert_allclose(node, want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=str(path))


def test_conv_transe_parameter_layout_and_dropout():
    """The bridge keeps ``conv_w`` (C, 2, ks) as it is and transposes
    ``fc``; in train mode the three dropout masks come from the caller's
    generator, so one seed gives one result."""
    params, _, mod = _conv_transe(channels=4, ks=5)
    sd = params_from_jax(params)
    assert tuple(sd["conv_w"].shape) == (4, 2, 5)
    assert tuple(sd["fc.weight"].shape) == (D, 4 * D)
    assert params_to_jax(dict(mod.named_parameters())).keys() == \
        params.keys()
    ent, sub, rel = map(_t, _inputs(60))
    runs = [mod(ent, sub, rel, train=True,
                generator=torch.Generator().manual_seed(s)).detach()
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    fresh = td.ConvTransE(D, 4, 5, torch.Generator().manual_seed(0))
    assert float(fresh.conv_w.detach().abs().max()) <= 1 / np.sqrt(10)
    assert not fresh.conv_b.any()


@pytest.mark.cuda
def test_cuda_decoders_match_cpu():
    """The three heads on the GPU against the CPU from the same
    parameters: scores 1e-5, ConvTransE in eval and train mode (dropout
    0) and its running statistics after two train calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, cpu = _conv_transe()
    gpu = td.ConvTransE(D, 6, 3)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.cuda()
    for seed, train in ((70, False), (80, True), (90, True)):
        ent, sub, rel = map(_t, _inputs(seed))
        kw = dict(train=train, **DROP0)
        want = cpu(ent, sub, rel, **kw).detach()
        got = gpu(ent.cuda(), sub.cuda(), rel.cuda(), **kw).detach().cpu()
        torch.testing.assert_close(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)
    for (name, a), (_, b) in zip(gpu.named_buffers(), cpu.named_buffers()):
        torch.testing.assert_close(a.cpu(), b, rtol=TOL, atol=TOL,
                                   msg=name)
    link = td.LinkPredictor(D)
    z = _t(_normal(100, B, M, D))
    want = link(z[:, 0], z).detach()
    got = link.cuda()(z[:, 0].cuda(), z.cuda()).detach().cpu()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
