"""What a run loads: no module of JAX or of the JAX package (top-level
names compared whole, since the port's name begins with the JAX
package's), and a reference that loads nothing of the port.  Each case
runs in a fresh interpreter, so that this process's modules do not
count."""
import json
import os
import subprocess
import sys

from conftest import ROOT

RUN_CELL = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import small_cell, SMALL
from bench_cuda import harness
res = harness.run_cell(small_cell('tgn_memory.wiki.val'), 3, 0.1, False,
                       'cpu', harness.Clock(time.perf_counter()), SMALL,
                       log=lambda m: None)
print(json.dumps({{'correct': res['correct'],
                  'found': harness.forbidden_modules(),
                  'port': 'tgb_tgn_dgl_tpu_torch' in sys.modules}}))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from bench_cuda.stream import synthetic
from bench_cuda.reference import tgn as ref
s = synthetic('tgbl-wiki-small', seed=2, neg_splits=('val',))
m = ref.Model(D=100, H=8, F=32, K=10, P=32, memory=True, drop=0.2,
              att_drop=0.2, lr=1e-4)
w = ref.make_weights(m, 2, 'cpu')
r = ref.train_steps(s, m, w, 2, 2000, [6144], 'cpu')
st, mem = ref.train_epoch_state(s, m, 2, 2000, 1, w, 'cpu')
v = ref.val_pass(s, m, w, st, mem, 2000, 'cpu')
tops = sorted({{k.split('.')[0] for k in sys.modules}})
print(json.dumps({{'loss': r.losses[0], 'mrr': v.mrr, 'tops': tops}}))
"""


def _py(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _py(RUN_CELL.format(root=ROOT, tests=os.path.dirname(__file__)))
    assert got["correct"] and got["port"]
    assert got["found"] == []


def test_forbidden_names_are_compared_whole():
    from bench_cuda import harness
    sys.modules.setdefault("tgb_tgn_dgl_tpu_torch_probe_only", sys)
    try:
        assert "tgb_tgn_dgl_tpu_torch_probe_only" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["tgb_tgn_dgl_tpu_torch_probe_only"]


def test_the_reference_loads_nothing_of_the_port():
    got = _py(REFERENCE_ONLY.format(root=ROOT))
    assert got["loss"] > 0 and got["mrr"] > 0
    for top in ("tgb_tgn_dgl_tpu_torch", "tgb_tgn_dgl_tpu", "jax",
                "jaxlib", "flax"):
        assert top not in got["tops"]
