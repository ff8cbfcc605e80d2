"""``train.remat`` in the port: the memory-mode embedding recomputed in the
backward (``torch.utils.checkpoint``), as the JAX Engine wraps its embed
closure in ``jax.checkpoint`` (tgb_tgn_dgl_tpu engine/train.py:383-396).

The JAX remat is bit-exact by construction (the same program, another
autodiff schedule), so the port's is held to its own run without remat:
the mailbox memory (TGN), DyRep and JODIE at dropout 0.2, 4 steps each,
every parameter, Adam moment, generator state and ``MemoryState`` field
bit-equal.  Dropout 0 could not show the fault this guards against: every
mask comes from the engine's explicit generator, which checkpoint's
``preserve_rng_state`` does not restore, so a recompute that drew from it
again would take other masks.  A planted control does just that and must
differ.  The embedding runs twice a step with remat (the forward and the
recompute) and once without; the frozen step does not read the knob, as
in JAX."""
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from test_torch_fit import _data, _raw

import tgb_tgn_dgl_tpu_torch.engine.train as train_mod
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

STEPS = 4
ARCHS = {"memory": dict(memory=True),
         "dyrep": dict(memory=True, arch="dyrep", rnn=True),
         "jodie": dict(memory=True, arch="identity", rnn=True)}


def _engine(case, remat):
    raw = _raw(dropout=0.2, **ARCHS[case])
    raw = dict(raw, train=[dict(raw["train"][0], remat=remat,
                                sanity_batches=STEPS)])
    return Engine(_data(), parse_config_dict(raw), device="cpu")


def _counting_embed(monkeypatch):
    calls = []
    embed = train_mod.arch_embed

    def counted(*args, **kw):
        calls.append(kw["train"])
        return embed(*args, **kw)

    monkeypatch.setattr(train_mod, "arch_embed", counted)
    return calls


def _state(eng):
    st = {f"param/{k}": v for k, v in eng.model.state_dict().items()}
    for i, p in enumerate(eng.model.parameters()):
        st.update({f"adam/{i}/{k}": v
                   for k, v in eng.optimizer.state[p].items()})
    if eng.mem_state is not None:
        st.update({f"mem/{f}": getattr(eng.mem_state, f)
                   for f in eng.mem_state._fields})
    st["generator"] = eng.generator.get_state()
    return st


def _differing(a, b):
    assert a.keys() == b.keys()
    return [k for k in a if not torch.equal(a[k], b[k])]


def _train(eng):
    stats = eng.train_epoch()
    assert eng.last_epoch_trace["batches"] == STEPS
    return stats


@pytest.fixture(scope="module")
def without_remat():
    """Each case's state after 4 steps without remat."""
    out = {}
    for case in ARCHS:
        eng = _engine(case, remat=False)
        out[case] = (_train(eng), _state(eng))
    return out


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_remat_is_bit_equal_to_no_remat(case, without_remat, monkeypatch):
    calls = _counting_embed(monkeypatch)
    eng = _engine(case, remat=True)
    stats = _train(eng)
    assert calls == [True] * (2 * STEPS)
    want_stats, want = without_remat[case]
    assert stats == want_stats
    assert _differing(_state(eng), want) == []


@pytest.mark.parametrize("case", ["memory", "dyrep"])
def test_recompute_without_the_replayed_generator_differs(case,
                                                          without_remat):
    """The planted control: the recompute draws from the live generator
    (checkpoint's own ``preserve_rng_state`` does not cover it), so the
    backward sees other masks than the forward used."""
    eng = _engine(case, remat=True)

    def naive(pack, mem_rows, lu_rows):
        def run(m, lu):
            return train_mod.arch_embed(
                eng.model, eng.arch, eng.model_cfg, m, lu, eng.feats, pack,
                train=True, generator=eng.generator, local=True)
        return checkpoint(run, mem_rows, lu_rows, use_reentrant=False)

    eng._remat_embed = naive
    _train(eng)
    bad = _differing(_state(eng), without_remat[case][1])
    assert any(k.startswith("param/") for k in bad), bad


def test_frozen_step_ignores_remat(monkeypatch):
    calls = _counting_embed(monkeypatch)
    raw = _raw(dropout=0.2)
    raw = dict(raw, train=[dict(raw["train"][0], remat=True,
                                sanity_batches=2)])
    eng = Engine(_data(), parse_config_dict(raw), device="cpu")
    eng.train_epoch()
    assert calls == [True, True]
