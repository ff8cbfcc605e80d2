"""The DyGFormer cell (``dygformer.wiki.train``) on the CPU at the
tgbl-wiki-small preset, its widths and batch cut so that a run takes
seconds: it runs ``correct``; a step that leaves the state unchanged and
a loss over half the batch, planted in the program and in the reference,
read past the cell's limits; the benchmark's copy of the reference is
``baselines/dygformer_reference.py``; the frozen step cost matches a
count by hand; the MFU reader reads the reference's sizes."""
import filecmp
import os
import time

import pytest

from conftest import ROOT, SMALL, small_cell

NAME = "dygformer.wiki.train"
CUT = {"node_feat_dim": 16, "channel_embedding_dim": 8, "dim_time": 16,
       "max_input_sequence_length": 8}


def _cell():
    """The cell with its widths and batch cut for the CPU."""
    cell = small_cell(NAME)
    config = dict(cell.config)
    tgl = {k: [dict(v[0])] for k, v in config["tgl"].items()}
    tgl["gnn"][0].update(CUT)
    config["tgl"] = tgl
    return cell._replace(config=config,
                         traffic=dict(cell.traffic, batch_size=200))


def _result(seed=6):
    from bench_cuda import harness
    return harness.run_cell(_cell(), seed, 0.1, False, "cpu",
                            harness.Clock(time.perf_counter()), SMALL,
                            log=lambda m: None)


def _still_step(orig):
    def step(self, pack, acc):
        keep = {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}
        out = orig(self, pack, acc)
        self.model.load_state_dict(keep)
        return out
    return step


def _half_loss(orig):
    def loss(pos, neg, valid):
        half = valid.clone()
        half[len(half) // 2:] = False
        return orig(pos, neg, half & valid)
    return loss


def test_cell_is_correct_and_program_faults_are_caught(monkeypatch):
    from tgb_tgn_dgl_tpu_torch.engine import train
    res = _result()
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_edges_per_s"]["value"] > 0
    with monkeypatch.context() as m:
        m.setattr(train.Engine, "_train_step",
                  _still_step(train.Engine._train_step))
        res = _result()
        assert not res["correct"], res["checks"]
    with monkeypatch.context() as m:
        m.setattr(train, "pair_bce_loss", _half_loss(train.pair_bce_loss))
        res = _result()
        assert not res["correct"], res["checks"]


def test_reference_faults_read_past_the_limits():
    from bench_cuda import check, harness
    run = harness.Run(_cell(), 8, "cpu", harness.Clock(time.perf_counter()),
                      SMALL)
    run.outputs()
    base = run.reference()
    sound = check.judge(run.numbers(base), run.cell.limits)
    assert all(c["ok"] for c in sound.values()), sound
    for fault in ("half_batch", "still"):
        got = check.judge(run.numbers(base, run.as_program(
            run.reference(**{fault: True}))), run.cell.limits)
        assert not all(c["ok"] for c in got.values()), (fault, got)


def test_reference_copy_is_the_baseline():
    assert filecmp.cmp(
        os.path.join(ROOT, "bench_cuda", "reference", "dygformer.py"),
        os.path.join(ROOT, "baselines", "dygformer_reference.py"),
        shallow=False)


def test_step_cost_matches_a_count_by_hand():
    from bench_cuda.dygformer_flops import dygformer_step_cost
    # B 3 events, M 1: 6 pairs; L 4, patch 2: 2 tokens an end, 4 a pair;
    # C 2 (D 8), node 3, edge 5, time 4, one layer
    cost = dygformer_step_cost(B=3, M=1, L=4, patch=2, C=2, layers=1,
                               node_dim=3, edge_dim=5, time_dim=4,
                               n_params=100, train=True)
    chan = 2 * (3 * 3 * 2) * 2 * (3 + 5 + 4) * 2        # 9 ends x 2 tokens
    # 6 pairs x 8 positions x 2 counts; then 24 pair tokens projected
    cooc = 2 * 96 * 2 + 2 * 96 * 2 * 2 + 2 * 24 * 4 * 2
    layer = (2 * 24 * 8 * 24 + 2 * 2 * 6 * 16 * 8 + 2 * 24 * 8 * 8
             + 2 * 2 * 24 * 8 * 32)
    out = 2 * 12 * 8 * 3 + 2 * 6 * (2 * 3 * 3 + 3)
    fwd = chan + cooc + layer + out
    assert cost["flops_fwd"] == fwd
    assert cost["flops_encoder"] == layer
    assert cost["flops"] == 3 * fwd + 1000


def test_mfu_reader_reads_the_reference_sizes():
    from bench_cuda import spec
    from bench_cuda.dygformer_flops import dygformer_step_cost
    from bench_cuda.flops import H100_PEAK_FP32_FLOPS
    cell = spec.cell(NAME, spec.benchmark())
    ref = spec.reference(cell.config, "train_epoch")
    ctx = {"phase": "train", "B": 2000, "batches": 56, "window_s": 2.0,
           "n_params": 1_087_035, **ref.layer_context(ref.model_of(
               cell.config, 172))}
    want = dygformer_step_cost(B=2000, M=1, L=32, patch=1, C=50, layers=2,
                               node_dim=172, edge_dim=172, time_dim=100,
                               n_params=1_087_035)["flops"]
    read = spec.metric_reader("dygformer_train_mfu_pct")
    assert read(ctx) == pytest.approx(100 * 56 * want / 2.0
                                      / H100_PEAK_FP32_FLOPS, rel=1e-12)
    assert read(dict(ctx, phase="val")) is None
    assert read({"phase": "train"}) is None


@pytest.mark.cuda
def test_control_fails_on_the_card(cuda):
    """At the published widths on the card: the reference in float32
    passes the cell's limits, the reference in TF32 does not."""
    from bench_cuda import check, harness
    run = harness.Run(small_cell(NAME), 9, "cuda",
                      harness.Clock(time.perf_counter()), SMALL)
    run.outputs()
    base = run.reference()
    sound = check.judge(run.numbers(base), run.cell.limits)
    assert all(c["ok"] for c in sound.values()), sound
    control = check.judge(run.numbers(base, run.as_program(
        run.reference(tf32=True))), run.cell.limits)
    assert not all(c["ok"] for c in control.values()), control
