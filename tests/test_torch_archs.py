"""JODIE (``gnn.arch: identity``) and DyRep (``gnn.arch: dyrep``) in the
port (tgb_tgn_dgl_tpu_torch/models/variants.py, models/factory.py, the
Engine) against the JAX package on the same seeded numpy inputs, with
bridged weights, on the CPU.

  * the eager memory (``eager_apply_mail`` at S = 1 and at S = 2 with
    'last' and 'mean', outputs and gradients; ``eager_commit``),
    ``dyrep_messages`` for the four toggle pairs, the time projection and
    JODIE's ``arch_embed`` on a packed batch: 1e-6 abs+rel on values (a
    few fp32 products and sums each; the commit moves values), 1e-5 on
    parameter gradients (each a sum over the read set's rows, reduced in
    another order: 1e-6 fails at 1.4e-6 on a 24-row sum);
  * the bridge: JODIE's and DyRep's parameter trees both ways (JODIE's
    ``{"w": (1, D), "b"}`` as ``jodie.weight`` (D, 1) of an
    ``nn.Linear``), ``eager_memory_state_from_jax``;
  * Engine locksteps with the JAX Engine on the tiny stream of
    tests/test_torch_engine.py (``_run_lockstep``; dropout 0): JODIE,
    DyRep with the toggles (F, F) and (F, T), 6 steps; per-step losses
    and the parameters after at 1e-4 (``TOL``), then the val pass by
    column chunks and the test pass by the slot-unique protocol (the JAX
    side's ``eval_slot_unique`` set for each), MRR within 1e-3 and the
    memory state after each (``mem`` and DyRep's computed ``mail``
    within 1e-4 abs+rel, the rest exact; the mail's Δt-encoding columns,
    cos(w·Δt + b) at |Δt| up to about 10^3, within 1e-3: one ulp of such
    an fp32 argument is 6e-5, and from equal weights and state one val
    pass leaves 3.05e-5 there against at most 2.1e-6 in the other
    columns); DyRep at ``gnn.layer: 2``, a train epoch and a column-chunk
    val pass;
  * in the port alone: slot-unique eval equals column chunks exactly in
    MRR and within 1e-6 in the eager state, also with several embed
    chunks (``EVAL_UNIQUE_SLOTS`` = 256), where DyRep's mail must read
    the full slot map;
  * the configs, and an unknown ``gnn.arch``.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import TOL, MRR_TOL, RAW, _run_lockstep, _with_train

from tgb_tgn_dgl_tpu.models import variants as jv
from tgb_tgn_dgl_tpu.models.factory import (arch_embed as jax_arch_embed,
                                            init_arch_params)
from tgb_tgn_dgl_tpu.models.memory import (
    MemoryModelConfig as JaxMemoryModelConfig,
    init_memory_params as jax_init_memory_params)
from tgb_tgn_dgl_tpu.models.tgnn import TGNNConfig as JaxTGNNConfig
from tgb_tgn_dgl_tpu.ops.time_encode import init_time_encode
from tgb_tgn_dgl_tpu.utils.config import parse_config as jax_parse_config
from tgb_tgn_dgl_tpu_torch.bridge import (eager_memory_state_from_jax,
                                          memory_state_from_jax,
                                          params_from_jax, params_to_jax)
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
from tgb_tgn_dgl_tpu_torch.data.packer import (PackerConfig, StreamPacker,
                                               to_device)
from tgb_tgn_dgl_tpu_torch.engine import train as port_train
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.models import variants as tv
from tgb_tgn_dgl_tpu_torch.models.factory import (ARCHS, Jodie, arch_embed,
                                                  init_arch)
from tgb_tgn_dgl_tpu_torch.models.memory import (MemoryModelConfig,
                                                 init_memory)
from tgb_tgn_dgl_tpu_torch.models.tgnn import TGNNConfig
from tgb_tgn_dgl_tpu_torch.ops.time_encode import TimeEncode
from tgb_tgn_dgl_tpu_torch.utils.config import (parse_config,
                                                parse_config_dict)

ROOT = Path(__file__).resolve().parents[1]
VAR_TOL = 1e-6
GRAD_TOL = 1e-5
STATE_TOL = 1e-6          # port slot-unique vs port column chunks
TE_TOL = 1e-3             # DyRep mail's Δt encoding, port vs JAX
N, D, F, E, U = 40, 8, 5, 200, 24


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- variants
def _eager_cfgs(combine, **toggles):
    kw = dict(num_nodes=N, mail_dim=2 * D + F + D, memory_dim=D,
              combine=combine, **toggles)
    return jv.EagerMemoryConfig(**kw), tv.EagerMemoryConfig(**kw)


def _random_eager_state(S, seed):
    """About 40% of the slots empty, the trash row zero."""
    rng = np.random.default_rng(seed)
    n1, M = N + 1, 2 * D + F + D
    st = dict(
        mem=rng.normal(size=(n1, D)).astype(np.float32),
        last_update=rng.uniform(0, 50, n1).astype(np.float32),
        mail=rng.normal(size=(n1, S, M)).astype(np.float32),
        mail_t=rng.uniform(50, 100, (n1, S)).astype(np.float32),
        mail_eid=rng.permutation(E)[:n1 * S].reshape(n1, S).astype(np.int32),
        mail_valid=rng.random((n1, S)) < 0.6)
    for a in st.values():
        a[N] = 0
    return jv.EagerMemoryState(**st)


def _read_set(seed):
    """U entries: distinct nodes, then padding at the trash row N."""
    rng = np.random.default_rng(seed)
    uniq = np.full(U, N, np.int32)
    uniq[:U - 5] = np.sort(rng.permutation(N)[:U - 5])
    return uniq


def _eager_memory(jcfg, tcfg, seed):
    params = jv.init_eager_memory_params(jax.random.PRNGKey(seed), jcfg)
    mod = tv.init_eager_memory(tcfg)
    mod.load_state_dict(params_from_jax(params))
    return params, mod


EAGER_SLOTS = [(1, "last"), (2, "last"), (2, "mean")]
EAGER_IDS = ["S1", "S2_last", "S2_mean"]


@pytest.mark.parametrize("S,combine", EAGER_SLOTS, ids=EAGER_IDS)
def test_eager_apply_mail_matches_jax(S, combine):
    """Rows and last-update times, and d/d(cell) of Σ rows·C."""
    jcfg, tcfg = _eager_cfgs(combine)
    params, mod = _eager_memory(jcfg, tcfg, seed=S)
    jst = _random_eager_state(S, seed=10 + S)
    uniq = _read_set(seed=20 + S)
    c = np.random.default_rng(3).normal(size=(U, D)).astype(np.float32)

    def jscalar(p):
        rows, _ = jv.eager_apply_mail(p, jcfg, jst, jnp.asarray(uniq))
        return jnp.sum(rows * c)

    jrows, jlu = jv.eager_apply_mail(params, jcfg, jst, jnp.asarray(uniq))
    jgrads = jax.grad(jscalar)(params)
    rows, lu = tv.eager_apply_mail(mod, tcfg,
                                   eager_memory_state_from_jax(jst), _t(uniq))
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(jrows),
                               rtol=VAR_TOL, atol=VAR_TOL)
    np.testing.assert_array_equal(lu.numpy(), np.asarray(jlu))
    none = ~jst.mail_valid[uniq].any(axis=1)
    assert none.any() and (~none).any()
    (rows * _t(c)).sum().backward()
    got = params_to_jax({n: p.grad for n, p in mod.named_parameters()})
    assert got.keys() == jgrads.keys() == {"cell"}
    for k, want in jgrads["cell"].items():
        assert np.abs(np.asarray(want)).max() > 0, k
        np.testing.assert_allclose(got["cell"][k], np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("S", [1, 2])
def test_eager_commit_matches_jax(S):
    """Trash-row duplicates in the read set and the write plan; the write
    plan's nodes are in the read set (clear, then write)."""
    jcfg, tcfg = _eager_cfgs("last")
    rng = np.random.default_rng(40 + S)
    jst = _random_eager_state(S, seed=50 + S)
    uniq = _read_set(seed=60 + S)
    rows = rng.normal(size=(U, D)).astype(np.float32)
    lu = rng.uniform(0, 100, U).astype(np.float32)
    W = 16
    pairs = [(int(u), s) for u in uniq[:6] for s in range(S)][:W - 4]
    mw_node = np.full(W, N, np.int32)
    mw_slot = np.zeros(W, np.int32)
    idx = rng.permutation(W)[:len(pairs)]
    mw_node[idx] = [p[0] for p in pairs]
    mw_slot[idx] = [p[1] for p in pairs]
    mw_mail = rng.normal(size=(W, jcfg.mail_dim)).astype(np.float32)
    mw_t = rng.uniform(100, 200, W).astype(np.float32)
    mw_eid = rng.integers(0, E, W).astype(np.int32)
    plan = (mw_node, mw_slot, mw_mail, mw_t, mw_eid)
    want = jv.eager_commit(jcfg, jv.EagerMemoryState(*map(jnp.asarray, jst)),
                           jnp.asarray(uniq), jnp.asarray(rows),
                           jnp.asarray(lu), *map(jnp.asarray, plan))
    got = tv.eager_commit(tcfg, eager_memory_state_from_jax(jst), _t(uniq),
                          _t(rows), _t(lu), *map(_t, plan))
    for f in jv.EagerMemoryState._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=VAR_TOL, atol=VAR_TOL,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert not getattr(got, f)[N].any(), f
    assert got.mail_valid.numpy()[mw_node[idx], mw_slot[idx]].all()


def _packed_batch(M=1, layers=1):
    """Three train batches to fill the cache, then the pack under test
    (M > 1 packs an eval chunk)."""
    data = synthetic("tgbl-wiki-small", num_edges=500, num_nodes=60,
                     msg_dim=F, num_neg=M, seed=7)
    packer = StreamPacker(data.num_nodes, PackerConfig(
        num_neighbors=5, batch_size=80, max_intra_block=8, layers=layers))
    rng = np.random.default_rng(1)
    for i in range(4):
        rows = np.arange(80 * i, 80 * (i + 1))
        src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
        neg = rng.choice(data.unique_dst(), (80, M)).astype(np.int32)
        pack = packer.pack(src, dst, t, rows, get_block(src, dst),
                           neg[:, 0] if M == 1 else neg, eval_mode=M > 1)
    return data, pack


@pytest.mark.parametrize("use_src,use_dst", [(False, False), (True, False),
                                             (False, True), (True, True)],
                         ids=["FF", "TF", "FT", "TT"])
def test_dyrep_messages_match_jax(use_src, use_dst):
    data, pack = _packed_batch()
    rng = np.random.default_rng(5)
    R, Un = pack.root_nid.shape[0], pack.uniq_nid.shape[0]
    embed = rng.normal(size=(R, D)).astype(np.float32)
    rows = rng.normal(size=(Un, D)).astype(np.float32)
    lu = rng.uniform(0, float(data.t[240]), Un).astype(np.float32)
    kw = dict(num_nodes=data.num_nodes, mail_dim=2 * D + F + D, memory_dim=D,
              use_src_emb=use_src, use_dst_emb=use_dst)
    tp = init_time_encode(D)
    tp["b"] = jnp.linspace(-0.3, 0.3, D, dtype=jnp.float32)
    want = jv.dyrep_messages(jv.EagerMemoryConfig(**kw), jnp.asarray(embed),
                             pack.device(), jnp.asarray(data.msg), tp,
                             jnp.asarray(rows), jnp.asarray(lu))
    time = TimeEncode(D)
    time.load_state_dict(params_from_jax(tp))
    got = tv.dyrep_messages(tv.EagerMemoryConfig(**kw), _t(embed),
                            to_device(pack, "cpu"), _t(data.msg), time,
                            _t(rows), _t(lu))
    assert got.shape == (2 * 80, 2 * D + F + D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=VAR_TOL,
                               atol=VAR_TOL)


def test_time_embedding_matches_jax():
    """Output and gradients; the init is normal(0, 1/√D) with zero bias."""
    rng = np.random.default_rng(8)
    params = jv.init_time_embedding(jax.random.PRNGKey(2), D)
    mem = rng.normal(size=(30, D)).astype(np.float32)
    dt = rng.uniform(0, 50, 30).astype(np.float32)
    c = rng.normal(size=(30, D)).astype(np.float32)
    want = jv.time_embedding(params, jnp.asarray(mem), jnp.asarray(dt))
    jgrads = jax.grad(lambda p: jnp.sum(jv.time_embedding(
        p, jnp.asarray(mem), jnp.asarray(dt)) * c))(params)
    emb = tv.TimeEmbedding(D)
    emb.load_state_dict(params_from_jax(params))
    got = emb(_t(mem), _t(dt))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=VAR_TOL, atol=VAR_TOL)
    (got * _t(c)).sum().backward()
    np.testing.assert_allclose(emb.weight.grad.numpy().T,
                               np.asarray(jgrads["w"]), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(emb.bias.grad.numpy(), np.asarray(jgrads["b"]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    big = tv.TimeEmbedding(400, torch.Generator().manual_seed(0))
    assert not big.bias.any()
    assert abs(float(big.weight.detach().std()) * np.sqrt(400) - 1) < 0.1


# ------------------------------------------------------- factory and bridge
def _model_cfgs():
    kw = dict(edge_feat_dim=F, hidden_dim=D, num_heads=2, feat_drop=0.0,
              attn_drop=0.0)
    return JaxTGNNConfig(**kw), TGNNConfig(**kw)


def _jax_tree(arch):
    """The JAX Engine's parameter tree of ``arch``: the model's and the
    memory's (DyRep's eager cell; JODIE's time encoder and cell)."""
    jcfg, _ = _model_cfgs()
    params = init_arch_params(jax.random.PRNGKey(0), arch, jcfg)
    if arch == "dyrep":
        params["memory"] = jv.init_eager_memory_params(
            jax.random.PRNGKey(1), _eager_cfgs("last")[0])
    else:
        params["memory"] = jax_init_memory_params(
            jax.random.PRNGKey(1), JaxMemoryModelConfig(
                num_nodes=N, raw_msg_dim=F, memory_dim=D, time_dim=D,
                updater="rnn"))
    return params


def _port_model(arch):
    _, cfg = _model_cfgs()
    model = init_arch(cfg, arch)
    if arch == "dyrep":
        model.memory = tv.init_eager_memory(_eager_cfgs("last")[1])
    else:
        model.memory = init_memory(MemoryModelConfig(
            num_nodes=N, raw_msg_dim=F, memory_dim=D, time_dim=D,
            updater="rnn"))
    return model


@pytest.mark.parametrize("arch", ["identity", "dyrep"])
def test_param_tree_round_trip(arch):
    """The JAX tree loads into the port's model by name and shape
    (strictly) and comes back equal, leaf for leaf."""
    params = _jax_tree(arch)
    model = _port_model(arch)
    model.load_state_dict(params_from_jax(params))
    back = params_to_jax(model.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(model.state_dict())
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=path)
    if arch == "dyrep":
        assert set(back["memory"]) == {"cell"}
    else:
        assert set(back["memory"]) == {"time", "cell"}


def test_jodie_time_projection_is_a_linear():
    """JODIE's {"w": (1, D), "b": (D,)} passes the bridge's linear test,
    so the port holds it as nn.Linear(1, D): ``jodie.weight`` (D, 1) is
    w transposed, and it goes back as (1, D)."""
    params = _jax_tree("identity")
    sd = params_from_jax(params)
    assert tuple(sd["jodie.weight"].shape) == (D, 1)
    np.testing.assert_array_equal(sd["jodie.weight"].numpy()[:, 0],
                                  np.asarray(params["jodie"]["w"])[0])
    model = _port_model("identity")
    assert isinstance(model, Jodie)
    assert isinstance(model.jodie, torch.nn.Linear)
    assert (model.jodie.in_features, model.jodie.out_features) == (1, D)
    model.load_state_dict(sd)
    back = params_to_jax(model.state_dict())
    assert back["jodie"]["w"].shape == (1, D)
    assert back["jodie"]["b"].shape == (D,)


@pytest.mark.parametrize("M", [1, 3], ids=["train", "eval"])
def test_jodie_arch_embed_matches_jax(M):
    """JODIE's embedding of a packed batch: each root's clock recovered
    from its KIND_SELF column, the time projection of its memory row,
    invalid root slots zero; and its gradients."""
    data, pack = _packed_batch(M)
    rng = np.random.default_rng(9)
    Un = pack.uniq_nid.shape[0]
    rows = rng.normal(size=(Un, D)).astype(np.float32)
    lu = rng.uniform(0, float(data.t[240]), Un).astype(np.float32)
    c = rng.normal(size=(pack.root_nid.shape[0], D)).astype(np.float32)
    jcfg, cfg = _model_cfgs()
    params = init_arch_params(jax.random.PRNGKey(4), "identity", jcfg)
    params["jodie"]["b"] = jnp.linspace(-0.2, 0.2, D, dtype=jnp.float32)
    jpack = pack.device()

    def jembed(p, r):
        return jax_arch_embed(p, "identity", jcfg, r, jnp.asarray(lu),
                              jnp.asarray(data.msg), jpack, train=True,
                              local=True)

    want = jembed(params, jnp.asarray(rows))
    jg_p, jg_r = jax.grad(lambda p, r: jnp.sum(jembed(p, r) * c),
                          argnums=(0, 1))(params, jnp.asarray(rows))
    model = init_arch(cfg, "identity")
    model.load_state_dict(params_from_jax(params))
    trows = _t(rows).requires_grad_(True)
    got = arch_embed(model, "identity", cfg, trows, _t(lu), _t(data.msg),
                     to_device(pack, "cpu"), train=True, local=True)
    assert (~pack.root_valid).any()
    assert not got[_t(~pack.root_valid)].any()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=VAR_TOL, atol=VAR_TOL)
    (got * _t(c)).sum().backward()
    np.testing.assert_allclose(trows.grad.numpy(), np.asarray(jg_r),
                               rtol=VAR_TOL, atol=VAR_TOL)
    # a sum over the roots of Δt·mem·C: terms of up to 10^3 that cancel,
    # so the bound is relative to the largest entry
    jw = np.asarray(jg_p["jodie"]["w"])
    np.testing.assert_allclose(model.jodie.weight.grad.numpy().T, jw,
                               rtol=GRAD_TOL,
                               atol=GRAD_TOL * np.abs(jw).max())


def test_unknown_arch_raises():
    _, cfg = _model_cfgs()
    with pytest.raises(ValueError, match="unknown gnn.arch"):
        init_arch(cfg, "not_an_arch")
    raw = dict(RAW, gnn=[dict(RAW["gnn"][0], arch="not_an_arch")])
    with pytest.raises(ValueError, match=r"supported: \('transformer"):
        Engine(_tiny(), parse_config_dict(raw), device="cpu")
    assert ARCHS == ("transformer_attention", "identity", "dyrep")


def test_memory_archs_refuse_a_disabled_memory():
    raw = dict(RAW, gnn=[dict(RAW["gnn"][0], arch="dyrep")],
               memory=[dict(type="none")])
    with pytest.raises(ValueError, match="needs the memory"):
        Engine(_tiny(), parse_config_dict(raw), device="cpu")


@pytest.mark.parametrize("name", ["JODIE", "DyRep"])
def test_yml_parses_like_jax_and_builds(name):
    """The port's JODIE.yml / DyRep.yml hold the JAX package's values,
    field for field; the Engine builds the memory model they name (with
    the memory whatever ``frozen_memory`` says)."""
    cfg = parse_config(ROOT / f"tgb_tgn_dgl_tpu_torch/configs/{name}.yml")
    jcfg = jax_parse_config(ROOT / f"tgb_tgn_dgl_tpu/configs/{name}.yml")
    for sec in ("sampling", "memory", "gnn", "train"):
        mine = dataclasses.asdict(getattr(cfg, sec))
        theirs = dataclasses.asdict(getattr(jcfg, sec))
        assert mine == {k: theirs[k] for k in mine}, sec
    cfg.train.frozen_memory = True
    eng = Engine(_tiny(), cfg, device="cpu")
    assert eng.use_memory and eng.eager_memory == (name == "DyRep")
    if name == "DyRep":
        assert cfg.memory.use_dst_emb_in_msg
        assert eng.mem_cfg.mail_dim == 2 * 100 + 8 + 100
        assert tuple(eng.mem_state.mail.shape) == (121, 1, 308)
        assert tuple(eng.model.memory.cell.w_ih.shape) == (308, 100)
    else:
        assert isinstance(eng.model, Jodie)
        assert eng.mem_cfg.updater == "rnn"


def test_eager_memory_state_from_jax():
    jst = _random_eager_state(2, seed=3)
    st = eager_memory_state_from_jax(jst)
    assert isinstance(st, tv.EagerMemoryState)
    for f in jst._fields:
        a, b = getattr(st, f), getattr(jst, f)
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    z = tv.init_eager_memory_state(_eager_cfgs("last")[1], 2)
    jz = jv.init_eager_memory_state(_eager_cfgs("last")[0], 2)
    for f in jz._fields:
        assert getattr(z, f).numpy().dtype == np.asarray(getattr(jz, f)).dtype
        assert getattr(z, f).shape == getattr(jz, f).shape, f


# ------------------------------------------------------------ the engines
def _tiny():
    return synthetic("tiny", num_edges=855, num_nodes=120, msg_dim=8,
                     num_neg=8, seed=1)


def _arch_raw(arch, use_src=False, use_dst=False, **gnn):
    return dict(_with_train(RAW, frozen_memory=False),
                memory=[dict(dim_out=32, dim_time=32, memory_update="rnn",
                             use_src_emb_in_msg=use_src,
                             use_dst_emb_in_msg=use_dst)],
                gnn=[dict(RAW["gnn"][0], arch=arch, **gnn)])


LOCKSTEPS = {"jodie": ("identity",), "dyrep_FF": ("dyrep",),
             "dyrep_FT": ("dyrep", False, True)}


def _state_copy(eng):
    return type(eng.mem_state)(*(x.clone() for x in eng.mem_state))


def _lockstep(name):
    """One train epoch in lockstep; then the val pass by column chunks and
    the test pass by the slot-unique protocol, on both engines."""
    run = _run_lockstep(_arch_raw(*LOCKSTEPS[name]))
    jeng, peng = run["jeng"], run["peng"]
    bridge = (eager_memory_state_from_jax if peng.eager_memory
              else memory_state_from_jax)
    run["train_state"] = (_state_copy(peng), bridge(jeng.mem_state))
    unique = []
    jrun = jeng._evaluate_unique
    jeng._evaluate_unique = lambda *a: unique.append(a[0]) or jrun(*a)
    run["val"] = (peng._evaluate_chunked("val"), jeng.evaluate("val"))
    run["val_state"] = (_state_copy(peng), bridge(jeng.mem_state))
    run["val_protocol"] = peng.last_eval_trace["protocol"]
    jeng.config.train.eval_slot_unique = True
    run["test"] = (peng.evaluate("test"), jeng.evaluate("test"))
    run["test_state"] = (_state_copy(peng), bridge(jeng.mem_state))
    run["test_protocol"] = peng.last_eval_trace["protocol"]
    run["jax_unique"] = unique
    run["packer"] = (peng.packer.snapshot(), jeng.packer.snapshot())
    return run


@pytest.fixture(scope="module")
def runs():
    return {}


@pytest.fixture(params=sorted(LOCKSTEPS))
def run(request, runs):
    name = request.param
    if name not in runs:
        runs[name] = _lockstep(name)
    return name, runs[name]


def _assert_state_match(got, want, when, tol=TOL, te_tol=TE_TOL):
    """``mem`` and (DyRep) the computed ``mail`` within ``tol`` abs+rel,
    the mail's last D columns (the Δt encoding) within ``te_tol``, every
    other field exactly."""
    assert type(got).__name__ == type(want).__name__
    D = want.mem.shape[1]
    for f in want._fields:
        a, b = getattr(got, f).numpy(), getattr(want, f).numpy()
        assert a.dtype == b.dtype, (when, f)
        if f == "mail":
            np.testing.assert_allclose(a[..., :-D], b[..., :-D], rtol=tol,
                                       atol=tol, err_msg=f"{when}: {f}")
            np.testing.assert_allclose(a[..., -D:], b[..., -D:],
                                       rtol=te_tol, atol=te_tol,
                                       err_msg=f"{when}: {f} Δt-enc")
        elif f == "mem":
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=f"{when}: {f}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{when}: {f}")


def test_engine_losses_and_params_match(run):
    name, r = run
    assert len(r["pl"]) == 6, name
    np.testing.assert_allclose(r["pl"], r["jl"], rtol=TOL, atol=TOL,
                               err_msg=name)
    for k in ("loss", "ap", "auc"):
        np.testing.assert_allclose(r["pstats"][k], r["jstats"][k], rtol=TOL,
                                   atol=TOL, err_msg=f"{name}: {k}")
    got = params_to_jax(r["peng"].model.state_dict())
    want = jax.tree.map(np.asarray, r["jeng"].params)
    assert got.keys() == want.keys()
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, leaf, rtol=TOL, atol=TOL,
                                   err_msg=f"{name}: {path}")


def test_engine_state_after_train_matches(run):
    name, r = run
    got, want = r["train_state"]
    assert got.mail_valid.any() and got.mem.abs().max() > 0
    _assert_state_match(got, want, f"{name} after the train epoch")


@pytest.mark.parametrize("split", ["val", "test"])
def test_engine_eval_mrr_and_state_match(run, split):
    """Val by column chunks, test by the slot-unique protocol on both
    sides: MRR within MRR_TOL, the memory state after each pass."""
    name, r = run
    pm, jm = r[split]
    assert 0.0 < pm <= 1.0 and abs(pm - jm) <= MRR_TOL, (name, pm, jm)
    _assert_state_match(*r[f"{split}_state"], f"{name} after {split}")
    assert r["val_protocol"] == "column_chunk"
    assert r["test_protocol"] == "slot_unique"
    assert r["jax_unique"] == ["test"]
    for x, y in zip(*r["packer"]):
        np.testing.assert_array_equal(x, y)


def test_dyrep_mail_is_built_before_the_adam_step(monkeypatch):
    """The mail of a DyRep train step reads the time encoder as it was
    before the step's update (JAX builds it from the step's parameters),
    and the step then moves it."""
    eng = Engine(_tiny(), parse_config_dict(_with_train(
        _arch_raw("dyrep"), sanity_batches=1)), device="cpu")
    before = eng.model.time.w.detach().clone()
    seen = []

    def spy(cfg, embed, pack, feats, time, *rest):
        seen.append(torch.equal(time.w.detach(), before))
        return tv.dyrep_messages(cfg, embed, pack, feats, time, *rest)

    monkeypatch.setattr(port_train, "dyrep_messages", spy)
    eng.train_epoch()
    assert seen == [True]
    assert not torch.equal(eng.model.time.w.detach(), before)


def test_dyrep_two_layers_lockstep():
    """DyRep at gnn.layer 2 (the rslot path under the eager mail): the
    train epoch and the val pass by column chunks (the gate closes at
    gnn.layer > 1), against the JAX Engine.  A full epoch: with
    ``sanity_batches`` the JAX loop packs batches past the limit (ROADMAP
    §3), and the stream states part."""
    r = _run_lockstep(_arch_raw("dyrep", False, True, layer=2))
    assert len(r["pl"]) == 6
    np.testing.assert_allclose(r["pl"], r["jl"], rtol=TOL, atol=TOL)
    pm, jm = r["peng"].evaluate("val"), r["jeng"].evaluate("val")
    assert r["peng"].last_eval_trace["protocol"] == "column_chunk"
    assert 0.0 < pm <= 1.0 and abs(pm - jm) <= MRR_TOL, (pm, jm)
    _assert_state_match(r["peng"].mem_state,
                        eager_memory_state_from_jax(r["jeng"].mem_state),
                        "layer 2 after val")


# ---------------------------------------- the port's two eval protocols
@pytest.mark.parametrize("slots", [None, 256], ids=["one_chunk", "256"])
@pytest.mark.parametrize("arch", ["identity", "dyrep"])
def test_unique_eval_matches_column_chunks(arch, slots, monkeypatch):
    """Val then test: slot-unique gives the column-chunk MRR exactly and
    leaves the same memory state (within 1e-6; DyRep's mail is computed
    from a table embedded in other chunks) and packer state; with a
    budget of 256 root slots a batch embeds in several chunks, and
    DyRep's mail reads the full slot map."""
    data = _tiny()
    raw = _arch_raw(arch, True, True) if arch == "dyrep" else _arch_raw(arch)
    a = Engine(data, parse_config_dict(raw), device="cpu")
    b = Engine(data, parse_config_dict(raw), device="cpu")
    for eng in (a, b):
        eng.train_epoch()
    if slots is not None:
        monkeypatch.setattr(port_train, "EVAL_UNIQUE_SLOTS", slots)
    for split in ("val", "test"):
        ma, mb = a._evaluate_chunked(split), b.evaluate(split)
        assert b.last_eval_trace["protocol"] == "slot_unique"
        assert 0.0 < mb <= 1.0 and ma == mb, (split, ma, mb)
        _assert_state_match(b.mem_state, a.mem_state, split, STATE_TOL,
                            STATE_TOL)
        for x, y in zip(a.packer.snapshot(), b.packer.snapshot()):
            np.testing.assert_array_equal(x, y)
    chunks, batches = (b.last_eval_trace[k] for k in ("embed_chunks",
                                                       "batches"))
    assert chunks > batches if slots else chunks == batches


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["identity", "dyrep"])
def test_cuda_arch_engine_matches_cpu(arch):
    """JODIE and DyRep on the GPU (DyRep's attention through the kernels)
    against the same engine on the CPU, same weights, dropout 0: losses
    1e-4, val (slot-unique) and test MRR 1e-3, the memory state (``mem``,
    ``mail`` 1e-4, the rest exact).  JODIE launches no kernel; DyRep the
    dropout-0 pair once a step and the inference forward once an embed
    chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tgb_tgn_dgl_tpu_torch.ops import attention
    out = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(_tiny(), parse_config_dict(_arch_raw(arch, False, True)),
                     device=dev)
        losses = []
        step = eng._train_step

        def rec(pack, acc, step=step, losses=losses):
            loss, acc = step(pack, acc)
            losses.append(float(loss))
            return loss, acc

        eng._train_step = rec
        attention.reset_launch_counts()
        eng.train_epoch()
        val = eng.evaluate("val")
        counts = dict(attention.launch_counts)
        chunks = eng.last_eval_trace["embed_chunks"]
        out[dev] = (losses, val, eng.evaluate("test"), eng.mem_state,
                    counts, chunks)
    (lg, vg, tg, sg, counts, chunks), (lc, vc, tc, sc, _, _) = \
        out["cuda"], out["cpu"]
    assert len(lg) == 6
    np.testing.assert_allclose(lg, lc, rtol=TOL, atol=TOL)
    assert abs(vg - vc) <= MRR_TOL and abs(tg - tc) <= MRR_TOL
    _assert_state_match(type(sg)(*(x.cpu() for x in sg)), sc, "gpu vs cpu")
    want = dict.fromkeys(attention.KERNELS, 0)
    if arch == "dyrep":
        want.update(attention_fwd=6, attention_bwd=6,
                    attention_fwd_infer=chunks)
    assert counts == want
