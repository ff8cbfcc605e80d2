"""bfloat16 compute (``train.compute_dtype: bfloat16``) of the port against
the JAX package on the CPU, same seeded inputs and bridged weights, dropout
0.  The JAX side runs the Pallas route (``use_pallas=True``,
``pallas_interpret=True``): its f32 casts of el′ and er around the
attention are the ones the port's ``attention_core`` mirrors.

  * ``tgnn_forward`` (``tgnn_embed`` and the predictor) at bf16 (frozen
    ones, a memory table, the local read, two layers, vector messages),
    eager on both sides: the logits, the loss, every parameter's gradient
    and the memory rows' gradient within the tolerances below; and a
    control: the port's fp32 forward of the same weights held to the same
    JAX bf16 numbers must fail the logit, parameter-gradient and memory-
    gradient checks (a port that skipped the casts would pass nothing);
  * the gradient reaches a bf16 el′ in bf16 through ``attention_core``;
  * the Engine, frozen and with the mailbox memory, 6 steps against the
    JAX Engine: per-step loss within ``ENGINE_LOSS_TOL``, with the fp32
    memory Engine as a control that must miss it; then, from the JAX
    side's weights and memory state, the slot-unique val pass on both
    sides: a bf16 embedding table on both, MRR within 1e-3.

Tolerances, each from the gap measured between the port and JAX (the
"port" reading) and between the port's fp32 forward and JAX bf16 (the
"control" reading), over the five cases:

  * logits: port at most 2.7e-7 apart, control 78 to 80 of the 80
    positive logits (238 to 240 of 240 negative ones) more than 1e-5
    apart, up to 7.8e-3.  ``LOGIT_TOL`` = 1e-5.  One run in about thirty
    put one negative logit one bf16 step (4e-3) from JAX: a product near a
    rounding boundary lands on the other side when the two libraries sum
    in another order.  So at most ``LOGIT_FLIPS`` = 1% of the logits may
    pass ``LOGIT_TOL``, each within one bf16 step, 2^-7;
  * the loss: port at most 1.2e-7 (7.0e-6 with that flip);
    ``LOSS_TOL`` = 2e-5;
  * parameter gradients, max over every entry: port 1.5e-7 (vector) to
    1.75e-3 (the time encoding's weight, frozen ones: the bf16 backward's
    roundings of sums over the whole grid), control 4.4e-3 to 2.1e-2.
    ``GRAD_TOL`` = 3e-3;
  * the memory rows' gradient, relative L2: port 2.9e-3 to 4.0e-3,
    control 1.1e-2 to 5.1e-2.  ``MEM_GRAD_RTOL`` = 6.5e-3.

The JAX Engine jit-compiles its step, and XLA's fusions keep bf16
intermediates in fp32 (measured: JAX's own bf16 forward under ``jax.jit``
against eager, logits up to 6.8e-3 apart).  So its losses are no
bit-level bf16 reference: over 6 Adam steps the port is up to 3.3e-4
from them, and the fp32 frozen Engine 3.1e-4, which no tolerance tells
apart; the fp32 memory Engine is 3.6e-3 away.  ``ENGINE_LOSS_TOL`` =
1e-3, with the memory control; the eager forward test above carries the
check of the casts."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_engine import (MRR_TOL, RAW, _data, _memory_raw,
                               _record_losses, _with_train)
from test_torch_multilayer import _pack

from tgb_tgn_dgl_tpu.data.dataset import synthetic as jax_synthetic
from tgb_tgn_dgl_tpu.engine.train import Engine as JaxEngine
from tgb_tgn_dgl_tpu.models.tgnn import TGNNConfig as JaxTGNNConfig
from tgb_tgn_dgl_tpu.models.tgnn import bce_loss as jax_bce_loss
from tgb_tgn_dgl_tpu.models.tgnn import init_tgnn as jax_init_tgnn
from tgb_tgn_dgl_tpu.models.tgnn import tgnn_forward as jax_tgnn_forward
from tgb_tgn_dgl_tpu.utils.config import parse_config_dict as jax_config
from tgb_tgn_dgl_tpu_torch.bridge import (memory_state_from_jax,
                                          params_from_jax, params_to_jax)
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.packer import to_device
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.models.tgnn import (TGNNConfig, bce_loss,
                                               init_tgnn, tgnn_forward)
from tgb_tgn_dgl_tpu_torch.ops.attention import attention_core
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

F, D, H = 6, 16, 4
LOGIT_TOL = 1e-5
LOGIT_FLIPS = 0.01
BF16_STEP = 2.0 ** -7
LOSS_TOL = 2e-5
GRAD_TOL = 3e-3
MEM_GRAD_RTOL = 6.5e-3
ENGINE_LOSS_TOL = 1e-3

CASES = {"frozen_ones": dict(const_ones=True),
         "memory_table": dict(),
         "local_read": dict(local=True),
         "layer2": dict(layers=2),
         "vector": dict(mode="vector")}


def _setup(case):
    """(data, pack, config kwargs, local, memory rows) of ``case``: the eval
    pack of tests/test_torch_multilayer.py (3 negatives an event)."""
    kw = CASES[case]
    layers = kw.get("layers", 1)
    data, pack = _pack(layers, M=3)
    common = dict(edge_feat_dim=F, hidden_dim=D, num_heads=H,
                  num_layers=layers, message_mode=kw.get("mode", "scalar"),
                  feat_drop=0.0, attn_drop=0.0,
                  const_ones_memory=kw.get("const_ones", False))
    local = kw.get("local", False)
    n = pack.uniq_nid.shape[0] if local else data.num_nodes
    mem = np.random.default_rng(3).normal(size=(n, D)).astype(np.float32)
    return data, pack, common, local, mem


def _params(common):
    return jax_init_tgnn(jax.random.PRNGKey(2), JaxTGNNConfig(**common))


def _port_forward(case, dtype):
    """The port's (pos, neg, loss, the memory rows' gradient) and its
    parameters' gradients at ``dtype``, from the JAX initial weights."""
    data, pack, common, local, mem = _setup(case)
    tcfg = TGNNConfig(**common, compute_dtype=getattr(torch, dtype))
    model = init_tgnn(tcfg)
    model.load_state_dict(params_from_jax(_params(common)))
    tmem = torch.from_numpy(mem).requires_grad_(True)
    tpack = to_device(pack, "cpu")
    pos, neg = tgnn_forward(model, tcfg, tmem, torch.from_numpy(data.msg),
                            tpack, train=True, local=local)
    loss = bce_loss(pos, neg, tpack.ev_valid)
    loss.backward()
    grads = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    return (pos, neg, loss, tmem.grad), grads


def _jax_forward(case, dtype):
    """The same from the JAX package on its Pallas route."""
    data, pack, common, local, mem = _setup(case)
    jcfg = JaxTGNNConfig(**common, use_pallas=True, pallas_interpret=True,
                         compute_dtype=jnp.dtype(dtype).type)
    jpack = pack.device()

    def jloss(p, m):
        pos, neg = jax_tgnn_forward(p, jcfg, m, jnp.asarray(data.msg), jpack,
                                    train=True, local=local)
        return jax_bce_loss(pos, neg, jpack.ev_valid), (pos, neg)

    (jl, (jpos, jneg)), (jg, jgm) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(_params(common),
                                             jnp.asarray(mem))
    return (jpos, jneg, jl, jgm), jg


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _misses(case, got, grads, want, jgrads):
    """The checks of ``got`` / ``grads`` against JAX's ``want`` /
    ``jgrads`` that fail, by name, each with its reading."""
    misses = {}
    logits = np.concatenate([_np(got[0]).ravel(), _np(got[1]).ravel()])
    jlogits = np.concatenate([_np(want[0]).ravel(), _np(want[1]).ravel()])
    gap = np.abs(logits - jlogits)
    if ((gap > LOGIT_TOL).mean() > LOGIT_FLIPS
            or gap.max() > BF16_STEP):
        misses["logits"] = ((gap > LOGIT_TOL).sum(), gap.max())
    if abs(float(_np(got[2]) - _np(want[2]))) > LOSS_TOL:
        misses["loss"] = (_np(got[2]), _np(want[2]))
    pairs = []

    def walk(g, j, path):
        if isinstance(j, dict):
            assert g.keys() == j.keys(), path
            for k in j:
                walk(g[k], j[k], f"{path}/{k}")
        else:
            pairs.append(np.abs(np.asarray(g) - np.asarray(j)).max())

    walk(grads, jgrads, "")
    if max(pairs) > GRAD_TOL:
        misses["grads"] = max(pairs)
    if not CASES[case].get("const_ones"):     # the frozen ones read no table
        gm, jm = _np(got[3]), _np(want[3])
        rel = np.linalg.norm(gm - jm) / np.linalg.norm(jm)
        if rel > MEM_GRAD_RTOL:
            misses["mem_grad"] = rel
    return misses


@pytest.mark.parametrize("case", sorted(CASES))
def test_tgnn_matches_jax_at_bf16(case):
    want, jgrads = _jax_forward(case, "bfloat16")
    got, grads = _port_forward(case, "bfloat16")
    assert _misses(case, got, grads, want, jgrads) == {}
    # the control: the port's fp32 forward of the same weights misses
    # JAX's bf16 numbers (bf16 really ran, and the tolerances see a cast)
    f32, f32_grads = _port_forward(case, "float32")
    control = _misses(case, f32, f32_grads, want, jgrads)
    expected = {"logits", "grads"} | (
        set() if CASES[case].get("const_ones") else {"mem_grad"})
    assert expected <= control.keys(), control


def test_attention_gradient_reaches_a_bf16_el_prime_in_bf16():
    g = torch.Generator().manual_seed(0)
    el = torch.randn(64, 9, 4, generator=g).bfloat16().requires_grad_(True)
    er = torch.randn(64, 4, generator=g).bfloat16().requires_grad_(True)
    mask = torch.rand(64, 9, generator=g) > 0.2
    out = attention_core(el, er, mask, 0.2)
    assert out.dtype == torch.float32
    out.square().sum().backward()
    assert el.grad.dtype == er.grad.dtype == torch.bfloat16
    assert el.grad.abs().max() > 0 and er.grad.abs().max() > 0
    # the fp32 gradient rounded, as the cast's backward rounds it
    el32 = el.detach().float().requires_grad_(True)
    er32 = er.detach().float().requires_grad_(True)
    attention_core(el32, er32, mask, 0.2).square().sum().backward()
    assert torch.equal(el.grad, el32.grad.bfloat16())
    assert torch.equal(er.grad, er32.grad.bfloat16())


# ---------------------------------------------------------------- engine
def _raw(memory):
    return _with_train(_memory_raw() if memory else RAW,
                       compute_dtype="bfloat16")


@pytest.fixture(scope="module", params=["frozen", "memory"])
def engines(request):
    """Both engines after 6 bf16 steps from the same weights; the JAX
    Engine on its Pallas route (interpret mode) with the slot-unique
    eval."""
    raw = _raw(request.param == "memory")
    jraw = dict(raw, gnn=[dict(raw["gnn"][0], use_pallas=True)],
                train=[dict(raw["train"][0], fuse_steps=1,
                            eval_slot_unique=True)])
    jeng = JaxEngine(_data(jax_synthetic), jax_config(jraw))
    jeng.model_cfg = jeng.model_cfg._replace(pallas_interpret=True)
    jeng._rebuild_steps()
    peng = Engine(_data(synthetic), parse_config_dict(raw), device="cpu")
    peng.model.load_state_dict(params_from_jax(jeng.params))
    jl, pl, cl = [], [], []
    _record_losses(jeng, jl)
    _record_losses(peng, pl)
    if request.param == "memory":
        # the control: the fp32 memory Engine from the same weights
        ceng = Engine(_data(synthetic), parse_config_dict(
            _with_train(_memory_raw(), compute_dtype="float32")),
            device="cpu")
        ceng.model.load_state_dict(params_from_jax(jeng.params))
        _record_losses(ceng, cl)
        ceng.train_epoch()
    jeng.train_epoch()
    peng.train_epoch()
    return dict(jeng=jeng, peng=peng, jl=jl, pl=pl, cl=cl)


def test_engine_losses_match_jax_at_bf16(engines):
    peng = engines["peng"]
    assert peng.model_cfg.compute_dtype == torch.bfloat16
    assert engines["jeng"].model_cfg.compute_dtype == jnp.bfloat16
    assert len(engines["pl"]) == 6
    np.testing.assert_allclose(engines["pl"], engines["jl"], rtol=0,
                               atol=ENGINE_LOSS_TOL)
    if engines["cl"]:
        gap = np.abs(np.subtract(engines["cl"], engines["jl"])).max()
        assert gap > ENGINE_LOSS_TOL, gap
    # parameters, Adam and the memory stay fp32
    assert all(p.dtype == torch.float32 for p in peng.model.parameters())
    assert all(t.dtype == torch.float32 for s in
               peng.optimizer.state.values() for t in s.values()
               if t.is_floating_point())
    if peng.use_memory:
        assert peng.mem_state.mem.dtype == torch.float32


def test_engine_slot_unique_val_matches_jax_at_bf16(engines):
    jeng, peng = engines["jeng"], engines["peng"]
    peng.model.load_state_dict(params_from_jax(jeng.params))
    if peng.use_memory:
        peng.mem_state = memory_state_from_jax(jeng.mem_state)
    tables = []
    counts = peng._unique_counts

    def spy(emb, *args):
        tables.append(emb.dtype)
        return counts(emb, *args)

    peng._unique_counts = spy
    jm = jeng.evaluate("val")
    pm = peng.evaluate("val")
    assert peng.last_eval_trace["protocol"] == "slot_unique"
    assert tables and set(tables) == {torch.bfloat16}
    assert 0.0 < pm <= 1.0
    assert abs(pm - jm) <= MRR_TOL, (pm, jm)
