"""The multi-process half of the port's multi-host primitives
(tgb_tgn_dgl_tpu_torch/parallel/multihost.py, owned_state.py) across two
processes over gloo, mirroring tests/test_multihost.py:254 and
tests/test_owned_distributed.py:88, and the port's CLI launched by
``torch.distributed.run`` on two processes.

The two processes run a worker script written to ``tmp_path`` (it imports
no JAX), joined through ``init_distributed`` at a ``file://`` store; each
checks its own results and writes them to ``tmp_path``:

  * ``multihost_allgather``: ragged payloads (3 and 5 entries) in rank
    order;
  * ``make_process_global_wire``: each process packs ITS edge range of a
    2-host super-batch, offsets its wire and all-gathers it over dp = 2;
    the composed forward loss on the global wire equals the mean of the
    per-host losses (each process derives both) within 1e-5;
  * ``DistributedOwnerExchange`` over ``multihost_allgather``, one owner a
    process (numpy and native owners), 3 super-batches: every field of the
    wire packed from the exchanged rows is bit-equal to the serial pack,
    and the owner's rows equal the serial state after each super-batch.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
pid, tmp = int(sys.argv[1]), sys.argv[2]
from tgb_tgn_dgl_tpu_torch.parallel.multihost import (
    align_wires, init_distributed, make_process_global_wire,
    multihost_allgather, offset_wire_for_host)
assert init_distributed("file://" + tmp + "/store", 2, pid) == pid
out = {}

# 1. the ragged all-gather
payload = np.arange(3 + 2 * pid, dtype=np.int64) + 10 * pid
out["allgather"] = [p.tolist() for p in multihost_allgather(payload)]

# 2. the process-global wire of a 2-host super-batch
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.dependency import get_block
from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig
from tgb_tgn_dgl_tpu_torch.engine.negatives import NegLinkSamplerDest
from tgb_tgn_dgl_tpu_torch.models.tgnn import (TGNNConfig, bce_loss,
                                               init_tgnn, tgnn_forward)
from tgb_tgn_dgl_tpu_torch.ops.wire import expand_wire, wire_to_device
from tgb_tgn_dgl_tpu_torch.parallel.mesh import make_mesh

data = synthetic("mh-2proc", num_edges=600, num_nodes=120, msg_dim=4,
                 num_neg=2, seed=33)
B, K, IW, N = 64, 5, 8, data.num_nodes
rows = np.nonzero(data.train_mask)[0]
cfg = PackerConfig(num_neighbors=K, batch_size=B, max_intra_block=IW,
                   root_bucket_lo=512)
model_cfg = TGNNConfig(edge_feat_dim=data.msg_dim, hidden_dim=16,
                       num_heads=2, feat_drop=0.0, attn_drop=0.0,
                       const_ones_memory=True)
model = init_tgnn(model_cfg, torch.Generator().manual_seed(0))
feats = torch.from_numpy(np.asarray(data.msg, np.float32))
sampler = NegLinkSamplerDest(data.unique_dst(), seed=5)

def loss_of(wire):
    with torch.no_grad():
        pack = expand_wire(wire_to_device(wire, "cpu"), K, IW, N)
        pos, neg = tgnn_forward(model, model_cfg, None, feats, pack,
                                train=False)
        return float(bce_loss(pos, neg, pack.ev_valid))

wires, losses = [], []
for h in range(2):            # both hosts' ranges, each from a fresh packer
    idx = rows[h * B:(h + 1) * B]
    src, dst, t = data.src[idx], data.dst[idx], data.t[idx]
    w, _ = NativeStreamPacker(N, cfg).pack_wire(
        src, dst, t, idx, get_block(src, dst), sampler.sample(dst))
    wires.append(w)
    losses.append(loss_of(w))
wires = [offset_wire_for_host(w, h, 2)
         for h, w in enumerate(align_wires(wires))]
mesh = make_mesh(2, dp=2, state=1)
out["global_loss"] = loss_of(make_process_global_wire(mesh, wires[pid]))
out["host_losses"] = losses
stacked = make_process_global_wire(
    mesh, type(wires[pid])(*(None if a is None else np.stack([a, a])
                             for a in wires[pid])), stacked=True)
out["stacked_shape"] = list(stacked.root_loc.shape)
out["stacked_equal"] = bool(np.array_equal(
    stacked.root_loc[1], np.concatenate([w.root_loc for w in wires])))

# 3. the owned exchange across the two processes
from tgb_tgn_dgl_tpu_torch.parallel.owned_state import (
    DistributedOwnerExchange, NativeNodeRangeOwnedState, NodeRangeOwnedState,
    pack_with_gathered_state)
data = synthetic("owned-2proc", num_edges=900, num_nodes=140, msg_dim=4,
                 num_neg=2, seed=57)
B, K, S, N = 75, 5, 2, data.num_nodes
cfg = PackerConfig(num_neighbors=K, batch_size=B, max_intra_block=8,
                   mailbox_size=S)
for kind, cls in (("numpy", NodeRangeOwnedState),
                  ("native", NativeNodeRangeOwnedState)):
    serial = NativeStreamPacker(N, cfg)          # the whole-state truth
    scratch = NativeStreamPacker(N, cfg)
    scratch._sticky = serial._sticky
    owner = cls(N, 2, pid, K, S)
    exchange = DistributedOwnerExchange(owner, pid, 2, multihost_allgather)
    rng = np.random.default_rng(3)               # one stream on both
    checked = 0
    for sb in range(3):
        batches = []
        for h in range(2):
            idx = np.arange((2 * sb + h) * B, (2 * sb + h + 1) * B)
            src, dst, t = data.src[idx], data.dst[idx], data.t[idx]
            neg = rng.integers(0, N, B).astype(np.int32)
            batches.append((src, dst, t, idx, get_block(src, dst), neg))
        got, giw, nbytes = pack_with_gathered_state(scratch, [exchange],
                                                    *batches[pid])
        assert nbytes > 0
        snap = serial.snapshot()
        want, wiw = serial.pack_wire(*batches[pid])
        assert giw == wiw, (giw, wiw)
        for f in type(want)._fields:
            a, b = getattr(want, f), getattr(got, f)
            if a is None and b is None:
                continue
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"{kind} sb {sb} proc {pid} field {f}")
            checked += 1
        serial.restore(snap)
        for b in batches:
            serial.pack_wire(*b)
            owner.apply_batch(b[0], b[1], b[2], b[4], b[5], e_id=b[3])
        sl = slice(owner.lo, owner.hi)
        np.testing.assert_array_equal(owner.cache_eid, serial.cache_eid[sl])
        np.testing.assert_array_equal(owner.clock, serial.clock[sl])
        np.testing.assert_array_equal(owner.mail_ptr, serial.mail_ptr[sl])
    out["owned_" + kind] = checked
json.dump(out, open(os.path.join(tmp, "out%d.json" % pid), "w"))
"""


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_proc")
    (tmp / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"),
                               str(i), str(tmp)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for i in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [f"proc {i} failed:\n{out[-4000:]}"
              for i, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, "\n".join(failed)
    return [json.loads((tmp / f"out{i}.json").read_text()) for i in range(2)]


def test_multihost_allgather_ragged(two_processes):
    for out in two_processes:
        assert out["allgather"] == [[0, 1, 2], [10, 11, 12, 13, 14]]


def test_process_global_wire_loss_is_the_mean_of_host_losses(two_processes):
    for out in two_processes:
        want = 0.5 * sum(out["host_losses"])
        assert abs(out["global_loss"] - want) < 1e-5, (out, want)
        # stacked wires gather along dim 1
        assert out["stacked_equal"]
    assert two_processes[0]["global_loss"] == two_processes[1]["global_loss"]


@pytest.mark.parametrize("kind", ["numpy", "native"])
def test_distributed_owner_exchange_packs_the_serial_wire(two_processes,
                                                          kind):
    for out in two_processes:
        assert out[f"owned_{kind}"] > 0


def test_cli_sharded_on_two_processes(tmp_path):
    """``torch.distributed.run --nproc-per-node 2`` of the port's CLI at
    --dp 2 on the CPU: rank 0 alone prints the epoch and writes the
    metrics log."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "tgb_tgn_dgl_tpu_torch.run_tgn",
         "--engine", "sharded", "--dp", "2", "--device", "cpu",
         "--data", "tgbl-wiki-small", "--synthetic", "--epochs", "1",
         "--log-dir", str(tmp_path / "run")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("Epoch: 01") == 1, out.stdout
    assert "[sharded {'dp': 2, 'state': 1}]" in out.stdout
    assert "engine: sharded over mesh {'dp': 2, 'state': 1} (gloo)" \
        in out.stdout
    events = [json.loads(l)["event"] for l in
              (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert events.count("train_epoch") == 1 and events.count("val") == 1
