"""The port's CLI (tgb_tgn_dgl_tpu_torch/run_tgn.py) in process, on the
CPU, on a tiny npz under ``--root`` with a tiny config (D = 8, 2 heads,
batch 100, 1,000 events):

  * ``main([..., "--device", "cpu"])`` prints the JAX CLI's lines (the
    repository's run_tgn.py on the same files and flags; numbers masked)
    and writes ``metrics.jsonl``, the checkpoints and the best model;
  * ``--resume`` trains the remaining epochs with continuing labels, and
    none when none is left — where run_tgn.py passes ``epochs=0`` and the
    JAX ``fit`` trains the config's ``train.epoch``;
  * ``--profile`` traces the first epoch into ``<log-dir>/profile`` with
    the same ``fit`` arguments as the others (its checkpoint is written);
  * ``--engine multihost --hosts 2 --exchange owned`` prints the JAX
    CLI's lines (its ``engine:`` line among them) and trains through the
    port's ``MultiHostEngine``;
  * ``--eval-every 2`` runs the val pass after the second epoch alone;
  * under NCCL each rank of ``--engine sharded`` takes its own card;
  * without a GPU and without ``--device``, ``main`` raises; a dataset
    that is not under ``--root`` falls back to the synthetic stream with
    run_tgn.py's note on stderr;
  * on the GPU (``cuda``-marked, skipped here): without ``--device`` the
    CLI trains and tests on the card, through the kernels.
"""
import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest
import torch

from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.run_tgn import main

ROOT = Path(__file__).resolve().parents[1]
CONFIG = """\
sampling:
  - layer: 1
    neighbor:
      - 5
    strategy: 'recent'
memory:
  - type: 'node'
    dim_time: 8
    dim_out: 8
gnn:
  - arch: 'transformer_attention'
    layer: 1
    att_head: 2
    dim_time: 8
    dim_out: 8
train:
  - epoch: 4
    batch_size: 100
    lr: 0.001
    dropout: 0.0
    att_dropout: 0.0
    frozen_memory: False
"""


@pytest.fixture
def files(tmp_path):
    """A tiny npz under <tmp>/ds and the tiny config."""
    (tmp_path / "ds").mkdir()
    synthetic("tiny", num_edges=1000, num_nodes=100, msg_dim=4, num_neg=8,
              seed=1).save_npz(str(tmp_path / "ds" / "tiny.npz"))
    (tmp_path / "tiny.yml").write_text(CONFIG)
    return tmp_path


def _args(files, *extra, log="run"):
    out = ["--data", "tiny", "--root", str(files / "ds"), "--config",
           str(files / "tiny.yml"), *extra]
    if log:
        out += ["--log-dir", str(files / log)]
    return out


def _mask(text):
    """The CLI's lines with their numbers masked; the eval gate's note
    ("[eval] slot-unique protocol off (…)") is left out: the JAX "auto"
    gate closes on this stream, the port's opens and says nothing."""
    return [re.sub(r"-?\d+(\.\d+)?", "#", line)
            for line in text.splitlines()
            if line.strip() and not line.startswith("[eval]")]


def _events(path):
    return [json.loads(line)["event"]
            for line in (path / "metrics.jsonl").read_text().splitlines()]


def _jax_cli(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_run_tgn",
                                                  ROOT / "run_tgn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["run_tgn.py", *argv])
    mod.main()


def test_main_prints_the_jax_cli_lines(files, capsys, monkeypatch):
    flags = ["--epochs", "2", "--checkpoint-every", "1", "--patience", "3",
             "--val-snapshot", "--run-test"]
    out = main(_args(files, *flags, "--device", "cpu"))
    mine = capsys.readouterr().out
    _jax_cli(_args(files, *flags, log="jax_run"), monkeypatch)
    theirs = capsys.readouterr().out
    assert _mask(mine) == _mask(theirs)
    assert mine.splitlines()[1].startswith("Epoch: 01, Loss: ")
    assert "Test mrr: " in mine and out["test"] is not None
    run = files / "run"
    assert sorted(p.name for p in run.iterdir()) == [
        "ckpt_epoch0001.pt", "ckpt_epoch0002.pt", "metrics.jsonl",
        "model_best.pt"]
    assert _events(run) == ["train_epoch", "val", "checkpoint"] * 2
    assert out["engine"]._epoch == 2 and out["engine"].device.type == "cpu"


def test_resume_trains_the_rest_and_none_when_none_is_left(files, capsys):
    main(_args(files, "--epochs", "2", "--checkpoint-every", "1",
               "--device", "cpu"))
    whole = main(_args(files, "--epochs", "3", "--device", "cpu",
                       log="whole"))
    capsys.readouterr()
    ckpt = str(files / "run" / "ckpt_epoch0002.pt")
    rest = main(_args(files, "--epochs", "3", "--resume", ckpt, "--device",
                      "cpu", log="rest"))
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == f"resumed from {ckpt} at epoch 2"
    assert lines[2].startswith("Epoch: 03, ")
    assert [len(h["loss"]) for h in rest["histories"]] == [1]
    assert rest["histories"][0]["loss"] == whole["histories"][0]["loss"][2:]
    assert rest["load_s"] >= 0
    # nothing left: no epoch at all (run_tgn.py would train train.epoch)
    none = main(_args(files, "--epochs", "2", "--resume", ckpt,
                      "--run-test", "--device", "cpu", log=None))
    lines = capsys.readouterr().out.splitlines()
    assert not any(line.startswith("Epoch:") for line in lines)
    assert none["histories"][0]["loss"] == [] and none["engine"]._epoch == 2
    # the config's 4 epochs when --epochs is not given: 2 more
    more = main(_args(files, "--resume", ckpt, "--device", "cpu", log=None))
    assert len(more["histories"][0]["loss"]) == 2
    assert more["engine"]._epoch == 4


def test_profile_traces_the_first_epoch_with_the_same_arguments(files):
    out = main(_args(files, "--epochs", "2", "--checkpoint-every", "1",
                     "--profile", "--device", "cpu"))
    run = files / "run"
    assert (run / "profile" / "trace.json").stat().st_size > 0
    json.loads((run / "profile" / "trace.json").read_text())
    assert (run / "ckpt_epoch0001.pt").exists()
    assert [len(h["loss"]) for h in out["histories"]] == [1, 1]
    assert _events(run) == ["train_epoch", "val", "checkpoint"] * 2


def test_eval_every_runs_the_val_pass_every_nth_epoch(files):
    out = main(_args(files, "--epochs", "2", "--eval-every", "2",
                     "--device", "cpu"))
    assert _events(files / "run") == ["train_epoch", "train_epoch", "val"]
    assert len(out["histories"][0]["val"]) == 1


def test_main_needs_a_gpu_unless_asked_for_the_cpu(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(_args(files, "--epochs", "1"))


@pytest.mark.parametrize("engine", ["sharded"])
def test_parallel_engines_are_not_ported(files, engine, capsys):
    """Every engine the CLI offers runs: ``--engine sharded`` at world
    size 1 on the CPU trains through ShardedEngine and names its mesh
    (tests/test_torch_sharded.py and test_torch_distributed.py hold it
    against the serial engine and on two processes)."""
    out = main(_args(files, "--engine", engine, "--dp", "1", "--state-ax",
                     "1", "--device", "cpu", "--epochs", "1"))
    assert type(out["engine"]).__name__ == "ShardedEngine"
    assert ("engine: sharded over mesh {'dp': 1, 'state': 1} (gloo)"
            in capsys.readouterr().out)
    assert len(out["histories"][0]["loss"]) == 1


def test_sharded_ranks_take_their_own_card():
    """Under NCCL a bare ``cuda`` is the rank's own card; a card named for
    a world of several ranks is refused unless it is the rank's."""
    from tgb_tgn_dgl_tpu_torch.run_tgn import rank_device
    assert rank_device(None, 2, 1) == "cuda:1"
    assert rank_device("cuda", 2, 1) == "cuda:1"
    assert rank_device("cuda:1", 2, 1) == "cuda:1"
    assert rank_device("cuda:0", 1, 0) == "cuda:0"
    with pytest.raises(ValueError, match="several ranks on one card"):
        rank_device("cuda:0", 2, 1)


def test_multihost_prints_the_jax_cli_lines(files, capsys, monkeypatch):
    """``--engine multihost --hosts 2 --exchange owned``: the JAX CLI's
    lines, the ``engine:`` line first after the dataset's, and an epoch of
    3 super-batches of 2 x 100 events and a tail batch of 100."""
    flags = ["--engine", "multihost", "--hosts", "2", "--exchange", "owned",
             "--epochs", "1", "--run-test"]
    out = main(_args(files, *flags, "--device", "cpu"))
    mine = capsys.readouterr().out
    _jax_cli(_args(files, *flags, log="jax_run"), monkeypatch)
    theirs = capsys.readouterr().out
    assert _mask(mine) == _mask(theirs)
    assert mine.splitlines()[1] == ("engine: multihost composed "
                                    "super-batches, hosts=2, exchange=owned")
    eng = out["engine"]
    assert type(eng).__name__ == "MultiHostEngine"
    assert eng.exchange == "owned" and eng.n_hosts == 2
    assert eng.last_epoch_trace["super_batches"] == 3
    assert eng.last_epoch_trace["batches"] == 7 and eng._step == 7
    assert 0.0 < out["test"] <= 1.0


def test_missing_dataset_falls_back_to_synthetic(files, capsys):
    out = main(["--data", "tgbl-nope", "--root", str(files / "ds"),
                "--config", str(files / "tiny.yml"), "--epochs", "0",
                "--device", "cpu"])
    err = capsys.readouterr().err
    assert "No dataset found for 'tgbl-nope'" in err
    assert err.rstrip().endswith("Falling back to synthetic stream.")
    assert out["engine"].data.name == "tgbl-nope"
    assert out["engine"].data.num_edges == 20_000


@pytest.mark.cuda
def test_main_runs_on_the_gpu_by_default(files):
    """Without --device the CLI trains and tests on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tgb_tgn_dgl_tpu_torch.ops import attention
    attention.reset_launch_counts()
    out = main(_args(files, "--epochs", "1", "--run-test"))
    assert out["engine"].device.type == "cuda"
    assert 0.0 < out["test"] <= 1.0
    assert attention.launch_counts["attention_fwd_infer"] > 0
