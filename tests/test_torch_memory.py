"""The port's mailbox memory (tgb_tgn_dgl_tpu_torch/ops/recurrent.py,
models/memory.py) against the JAX package's on the same numpy inputs,
made from a seed, with bridged weights.

Tolerances (fp32 on both sides): 1e-6 abs+rel on the cells (one (in, 3H)
product each); 1e-5 on ``apply_mail``'s rows and on its parameter
gradients (sums over the read set and the message width); ``commit``
moves values without arithmetic, so its int and bool fields must be
equal and its floats within 1e-6."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgb_tgn_dgl_tpu.models.memory import (
    MemoryModelConfig as JaxMemoryModelConfig, MemoryState as JaxMemoryState,
    apply_mail as jax_apply_mail, commit as jax_commit,
    init_memory_params as jax_init_memory_params)
from tgb_tgn_dgl_tpu.ops.recurrent import CELLS as JAX_CELLS
from tgb_tgn_dgl_tpu_torch.bridge import (memory_state_from_jax,
                                          params_from_jax, params_to_jax)
from tgb_tgn_dgl_tpu_torch.models.memory import (MemoryModelConfig,
                                                 apply_mail, commit,
                                                 init_memory,
                                                 init_memory_state)
from tgb_tgn_dgl_tpu_torch.ops.recurrent import CELLS

N, D, F, E, U = 40, 8, 5, 200, 24
CELL_TOL = 1e-6
TOL = 1e-5
FLOAT_FIELDS = ("mem", "last_update", "mail_t")


def _cfgs(S, combine, updater="gru"):
    kw = dict(num_nodes=N, raw_msg_dim=F, memory_dim=D, time_dim=D,
              mailbox_size=S, updater=updater, combine=combine)
    return JaxMemoryModelConfig(**kw), MemoryModelConfig(**kw)


def _random_state(S, seed):
    """A state with about 40% of the slots empty and the trash row zero."""
    rng = np.random.default_rng(seed)
    n1 = N + 1
    st = dict(
        mem=rng.normal(size=(n1, D)).astype(np.float32),
        last_update=rng.uniform(0, 50, n1).astype(np.float32),
        mail_src=rng.integers(0, N, (n1, S)).astype(np.int32),
        mail_dst=rng.integers(0, N, (n1, S)).astype(np.int32),
        mail_t=rng.uniform(50, 100, (n1, S)).astype(np.float32),
        mail_eid=rng.permutation(E)[:n1 * S].reshape(n1, S).astype(np.int32),
        mail_valid=rng.random((n1, S)) < 0.6,
    )
    for a in st.values():
        a[N] = 0
    return JaxMemoryState(**st)


def _read_set(seed):
    """U entries: distinct nodes, then padding at the trash row N."""
    rng = np.random.default_rng(seed)
    uniq = np.full(U, N, np.int32)
    uniq[:U - 5] = np.sort(rng.permutation(N)[:U - 5])
    return uniq


def _memory(S, combine, updater="gru", seed=0):
    jcfg, tcfg = _cfgs(S, combine, updater)
    params = jax_init_memory_params(jax.random.PRNGKey(seed), jcfg)
    # a nonzero time bias, so its gradient is not the trivial one
    params["time"]["b"] = jnp.linspace(-0.3, 0.3, D, dtype=jnp.float32)
    mod = init_memory(tcfg)
    mod.load_state_dict(params_from_jax(params))
    return jcfg, tcfg, params, mod


@pytest.mark.parametrize("updater", ["gru", "rnn"])
def test_cells_match_jax(updater):
    init, jcell = JAX_CELLS[updater]
    p = init(jax.random.PRNGKey(1), 12, D)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 12)).astype(np.float32)
    h = rng.normal(size=(7, D)).astype(np.float32)
    cell = CELLS[updater](12, D)
    cell.load_state_dict(params_from_jax(p))
    want = np.asarray(jcell(p, jnp.asarray(x), jnp.asarray(h)))
    got = cell(torch.from_numpy(x), torch.from_numpy(h)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=CELL_TOL, atol=CELL_TOL)


@pytest.mark.parametrize("updater", ["gru", "rnn"])
def test_cell_init_range_and_layout(updater):
    cell = CELLS[updater](12, D, torch.Generator().manual_seed(0))
    jp = JAX_CELLS[updater][0](jax.random.PRNGKey(0), 12, D)
    for name, p in cell.named_parameters():
        assert tuple(p.shape) == np.shape(jp[name]), name
        assert float(p.detach().abs().max()) <= 1.0 / np.sqrt(D), name


SLOTS = [(1, "last"), (3, "last"), (3, "mean")]
SLOT_IDS = ["S1", "S3_last", "S3_mean"]


@pytest.mark.parametrize("S,combine", SLOTS, ids=SLOT_IDS)
def test_apply_mail_matches_jax(S, combine):
    jcfg, tcfg, params, mod = _memory(S, combine)
    jst = _random_state(S, seed=S)
    uniq = _read_set(seed=S + 10)
    feats = np.random.default_rng(5).normal(size=(E, F)).astype(np.float32)
    jrows, jlu = jax_apply_mail(params, jcfg, jst, jnp.asarray(uniq),
                                jnp.asarray(feats))
    rows, lu = apply_mail(mod, tcfg, memory_state_from_jax(jst),
                          torch.from_numpy(uniq), torch.from_numpy(feats))
    assert rows.shape == (U, D) and lu.shape == (U,)
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(jrows),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(lu.numpy(), np.asarray(jlu))
    # rows without valid mail pass through unchanged
    none = ~jst.mail_valid[uniq].any(axis=1)
    assert none.any() and (~none).any()
    np.testing.assert_array_equal(rows.detach().numpy()[none],
                                  jst.mem[uniq][none])


@pytest.mark.parametrize("S,combine", SLOTS, ids=SLOT_IDS)
def test_apply_mail_grads_match_jax(S, combine):
    """d/d(time, cell) of Σ rows·C for a fixed random C."""
    jcfg, tcfg, params, mod = _memory(S, combine, seed=4)
    jst = _random_state(S, seed=20 + S)
    uniq = _read_set(seed=30 + S)
    feats = np.random.default_rng(6).normal(size=(E, F)).astype(np.float32)
    c = np.random.default_rng(7).normal(size=(U, D)).astype(np.float32)

    def jscalar(p):
        rows, _ = jax_apply_mail(p, jcfg, jst, jnp.asarray(uniq),
                                 jnp.asarray(feats))
        return jnp.sum(rows * c)

    jgrads = jax.grad(jscalar)(params)
    rows, _ = apply_mail(mod, tcfg, memory_state_from_jax(jst),
                         torch.from_numpy(uniq), torch.from_numpy(feats))
    (rows * torch.from_numpy(c)).sum().backward()
    got = params_to_jax({n: p.grad for n, p in mod.named_parameters()})
    for part in ("time", "cell"):
        assert got[part].keys() == jgrads[part].keys()
        for k in jgrads[part]:
            want = np.asarray(jgrads[part][k])
            assert np.abs(want).max() > 0, (part, k)
            np.testing.assert_allclose(got[part][k], want, rtol=TOL,
                                       atol=TOL, err_msg=f"{part}/{k}")


@pytest.mark.parametrize("S", [1, 3])
def test_commit_matches_jax(S):
    """Trash-row duplicates in the read set and in the write plan; the
    write plan's nodes are in the read set (so clear-then-write order
    matters)."""
    jcfg, tcfg = _cfgs(S, "last")
    rng = np.random.default_rng(40 + S)
    jst = _random_state(S, seed=50 + S)
    uniq = _read_set(seed=60 + S)
    rows = rng.normal(size=(U, D)).astype(np.float32)
    lu = rng.uniform(0, 100, U).astype(np.float32)
    W = 16
    real = uniq[:U - 5]
    pairs = [(int(u), s) for u in real[:6] for s in range(S)][:W - 4]
    mw_node = np.full(W, N, np.int32)
    mw_slot = np.zeros(W, np.int32)
    idx = rng.permutation(W)[:len(pairs)]
    mw_node[idx] = [p[0] for p in pairs]
    mw_slot[idx] = [p[1] for p in pairs]
    mw_partner = rng.integers(0, N, W).astype(np.int32)
    mw_t = rng.uniform(100, 200, W).astype(np.float32)
    mw_eid = rng.integers(0, E, W).astype(np.int32)
    plan = (mw_node, mw_slot, mw_partner, mw_t, mw_eid)
    want = jax_commit(jcfg, JaxMemoryState(*map(jnp.asarray, jst)),
                      jnp.asarray(uniq), jnp.asarray(rows),
                      jnp.asarray(lu), *map(jnp.asarray, plan))
    got = commit(tcfg, memory_state_from_jax(jst), torch.from_numpy(uniq),
                 torch.from_numpy(rows), torch.from_numpy(lu),
                 *map(torch.from_numpy, plan))
    for f in JaxMemoryState._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f in FLOAT_FIELDS:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    # new mail landed on read-set nodes, the trash row is zero
    assert got.mail_valid.numpy()[mw_node[idx], mw_slot[idx]].all()
    for f in JaxMemoryState._fields:
        assert not getattr(got, f)[N].any(), f


def test_init_memory_state_and_refusals():
    _, tcfg = _cfgs(2, "mean")
    st = init_memory_state(tcfg)
    assert st.mem.shape == (N + 1, D) and st.mail_valid.shape == (N + 1, 2)
    assert st.mail_src.dtype == torch.int32 and not st.mail_valid.any()
    with pytest.raises(ValueError, match="mail_combine"):
        init_memory(tcfg._replace(combine="max"))
    with pytest.raises(ValueError, match="memory_update"):
        init_memory(tcfg._replace(updater="lstm"))
