"""The plain reference against the port on the CPU, at the
tgbl-wiki-small preset: the first three train steps and the streaming
val pass, through the same ``Run`` the benchmark's set-up and check
use."""
import time

from conftest import SMALL, small_cell


def _run(name, seed):
    from bench_cuda import harness
    run = harness.Run(small_cell(name), seed, "cpu",
                      harness.Clock(time.perf_counter()), SMALL)
    if run.entry == "evaluate":
        run.window(0.0)
    run.outputs()
    return run


def test_train_steps_match_port():
    from bench_cuda import control
    run = _run("tgn_memory.wiki.train_b8000", 11)
    n = control.readings(run, run.reference())
    # both sides draw the same dropout masks and add in another order
    assert n["first_loss_gap"] < 1e-6
    assert max(n[f"loss_gap_step{i}"] for i in (1, 2, 3)) < 1e-6
    assert n["grad_gap_median"] < 1e-6
    assert n["grad_gap"] < 1e-5
    assert n["change_gap_median"] < 1e-5


def test_val_pass_matches_port():
    from bench_cuda import control
    run = _run("tgn_memory.wiki.val", 11)
    n = control.readings(run, run.reference(taus=control.TAUS))
    assert n["state_mismatch"] == 0
    assert n["mrr_gap"] < 1e-6
    assert n["memory_gap"] < 1e-6
    assert n["rank_gap"] <= 1.0
