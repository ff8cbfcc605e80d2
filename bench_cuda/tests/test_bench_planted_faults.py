"""A run with the timed path broken underneath comes out not correct:
the whole harness past its look for a card, on the CPU at the
tgbl-wiki-small preset, with each fault a cell can have planted in the
port.  One chip: no exchange between chips to leave out.  And, on the
card, the control (the reference in TF32, the precision below the
configuration's) fails a cell's numbers where the reference in float32
passes them."""
import time

import pytest
import torch

from conftest import SMALL, small_cell


def _correct(name, seed=6):
    from bench_cuda import harness
    res = harness.run_cell(small_cell(name), seed, 0.1, False, "cpu",
                           harness.Clock(time.perf_counter()), SMALL,
                           log=lambda m: None)
    return res["correct"], res["checks"]


def _still_step(orig):
    """A train step that returns its state unchanged."""
    def step(self, pack, acc):
        keep = {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}
        mem = (None if self.mem_state is None else
               [t.clone() for t in self.mem_state])
        out = orig(self, pack, acc)
        self.model.load_state_dict(keep)
        if mem is not None:
            self.mem_state = type(self.mem_state)(*mem)
        return out
    return step


def _half_loss(orig):
    """The loss over the first half of the batch, its mean over that."""
    def loss(pos, neg, valid, n_valid=None):
        half = valid.clone()
        half[len(half) // 2:] = False
        return orig(pos, neg, half & valid)
    return loss


def test_train_faults_are_caught(monkeypatch):
    from tgb_tgn_dgl_tpu_torch.engine import train
    name = "tgn_memory.wiki.train_b8000"
    ok, _ = _correct(name)
    assert ok
    with monkeypatch.context() as m:
        m.setattr(train.Engine, "_train_step",
                  _still_step(train.Engine._train_step))
        ok, checks = _correct(name)
        assert not ok, checks
    with monkeypatch.context() as m:
        m.setattr(train, "bce_loss", _half_loss(train.bce_loss))
        ok, checks = _correct(name)
        assert not ok, checks


def test_val_faults_are_caught(monkeypatch):
    from tgb_tgn_dgl_tpu_torch.engine import train
    name = "tgn_memory.wiki.val"
    ok, _ = _correct(name)
    assert ok
    # a val batch that leaves the memory and its mail as they were
    with monkeypatch.context() as m:
        m.setattr(train.Engine, "_commit", lambda self, *a, **k: None)
        ok, checks = _correct(name)
        assert not ok, checks
    # half of each batch's events left out of its mean
    orig_fin = train.Engine._finalize

    def half_fin(self, acc, opt, pes, valid):
        half = valid.clone()
        half[len(half) // 2:] = False
        return orig_fin(self, acc, opt, pes, half & valid)
    with monkeypatch.context() as m:
        m.setattr(train.Engine, "_finalize", half_fin)
        ok, checks = _correct(name)
        assert not ok, checks
    # an answer altered where it is produced: one event's rank counts
    orig_counts = train.Engine._unique_counts

    def altered(self, emb, wire, mask, n_mc):
        opt, pes = orig_counts(self, emb, wire, mask, n_mc)
        bump = torch.zeros_like(opt)
        bump[0] = mask.shape[1]
        return opt + bump, pes + bump
    with monkeypatch.context() as m:
        m.setattr(train.Engine, "_unique_counts", altered)
        ok, checks = _correct(name)
        assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tgn_memory.wiki.train_b8000",
                                  "tgn_memory.wiki.val"])
def test_control_fails_on_the_card(name, cuda):
    from bench_cuda import check, harness
    run = harness.Run(small_cell(name), 9, "cuda",
                      harness.Clock(time.perf_counter()), SMALL)
    if run.entry == "evaluate":
        run.window(0.0)
    run.outputs()
    base = run.reference()
    sound = check.judge(run.numbers(base), run.cell.limits)
    assert all(c["ok"] for c in sound.values()), sound
    control = check.judge(run.numbers(base, run.as_program(
        run.reference(tf32=True))), run.cell.limits)
    assert not all(c["ok"] for c in control.values()), control
