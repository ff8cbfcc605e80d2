"""Weight bridge (tgb_tgn_dgl_tpu_torch/bridge.py) and initializers: the
JAX ``init_tgnn`` pytree, with the mailbox memory's ``memory`` subtree,
round-trips exactly through the port's state_dict, and the port's own
init draws from the same distributions."""
import numpy as np
import pytest

import jax
import torch

from tgb_tgn_dgl_tpu.models.memory import (
    MemoryModelConfig as JaxMemoryModelConfig,
    init_memory_params as jax_init_memory_params,
    init_memory_state as jax_init_memory_state)
from tgb_tgn_dgl_tpu.models.tgnn import (TGNNConfig as JaxTGNNConfig,
                                         init_tgnn as jax_init_tgnn)
from tgb_tgn_dgl_tpu_torch.bridge import (memory_state_from_jax,
                                          params_from_jax, params_to_jax)
from tgb_tgn_dgl_tpu_torch.models.memory import (MemoryModelConfig,
                                                 MemoryState, init_memory)
from tgb_tgn_dgl_tpu_torch.models.tgnn import TGNNConfig, init_tgnn

F, D, H = 12, 64, 8


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_tree():
    return jax_init_tgnn(jax.random.PRNGKey(3),
                         JaxTGNNConfig(edge_feat_dim=F, hidden_dim=D,
                                       num_heads=H))


def test_roundtrip_is_exact(jax_tree):
    state = params_from_jax(jax_tree)
    model = init_tgnn(TGNNConfig(edge_feat_dim=F, hidden_dim=D, num_heads=H))
    model.load_state_dict(state)          # names and shapes all match
    back = _flat(params_to_jax(model.state_dict()))
    want = _flat(jax_tree)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_linears_are_transposed(jax_tree):
    state = params_from_jax(jax_tree)
    w = np.asarray(jax_tree["gat"]["fc_edge"]["w"])        # (in, out)
    assert w.shape == (F + D, H * D)
    np.testing.assert_array_equal(state["gat.fc_edge.weight"].numpy(), w.T)
    np.testing.assert_array_equal(state["time.w"].numpy(),
                                  np.asarray(jax_tree["time"]["w"]))


def test_init_distributions_match(jax_tree):
    """Same mean and std per leaf.  Tolerances follow the sampling error
    of the smallest leaf (attn_*: H·D = 512 draws, std error ≈ 3%): std
    within 15% relative, mean within 0.15 std.  The time encoding is
    deterministic and must be equal."""
    model = init_tgnn(TGNNConfig(edge_feat_dim=F, hidden_dim=D, num_heads=H),
                      torch.Generator().manual_seed(0))
    mine = _flat(params_to_jax(model.state_dict()))
    want = _flat(jax_tree)
    assert mine.keys() == want.keys()
    for k in want:
        a, b = mine[k], want[k]
        assert a.shape == b.shape, k
        if k.startswith("time/"):
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        if a.size < 100:      # out_fc bias: one draw
            assert abs(a).max() <= 1.0 / np.sqrt(D) + 1e-6, k
            continue
        assert abs(a.std() / b.std() - 1) < 0.15, (k, a.std(), b.std())
        assert abs(a.mean() - b.mean()) < 0.15 * b.std(), k


@pytest.mark.parametrize("updater", ["gru", "rnn"])
def test_memory_subtree_roundtrips(jax_tree, updater):
    """The model with its ``memory`` submodule takes the JAX tree with
    ``params["memory"]`` ({time: {w, b}, cell: {w_ih, w_hh, b_ih, b_hh}})
    under the names ``memory.time.w``, ``memory.cell.w_ih``, ..., without
    transposing, and gives it back exactly."""
    kw = dict(num_nodes=30, raw_msg_dim=F, memory_dim=D, time_dim=D,
              updater=updater)
    tree = dict(jax_tree, memory=jax_init_memory_params(
        jax.random.PRNGKey(4), JaxMemoryModelConfig(**kw)))
    state = params_from_jax(tree)
    np.testing.assert_array_equal(state["memory.cell.w_ih"].numpy(),
                                  np.asarray(tree["memory"]["cell"]["w_ih"]))
    model = init_tgnn(TGNNConfig(edge_feat_dim=F, hidden_dim=D, num_heads=H))
    model.memory = init_memory(MemoryModelConfig(**kw))
    model.load_state_dict(state)
    back = _flat(params_to_jax(model.state_dict()))
    want = _flat(tree)
    assert back.keys() == want.keys()
    assert {k for k in want if k.startswith("memory/")} == {
        "memory/time/w", "memory/time/b", "memory/cell/w_ih",
        "memory/cell/w_hh", "memory/cell/b_ih", "memory/cell/b_hh"}
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_memory_state_from_jax():
    cfg = JaxMemoryModelConfig(num_nodes=30, raw_msg_dim=F, mailbox_size=2)
    jst = jax_init_memory_state(cfg)
    jst = jst._replace(mem=jst.mem.at[3].set(1.5),
                       mail_valid=jst.mail_valid.at[4, 1].set(True),
                       mail_eid=jst.mail_eid.at[4, 1].set(17))
    st = memory_state_from_jax(jst)
    assert isinstance(st, MemoryState) and st._fields == jst._fields
    for f in st._fields:
        a, b = getattr(st, f).numpy(), np.asarray(getattr(jst, f))
        assert a.dtype == b.dtype and a.shape == (31,) + b.shape[1:], f
        np.testing.assert_array_equal(a, b, err_msg=f)
