"""One run of one cell: set-up, the measured window, the traced readings
and the comparison with the plain reference.

The set-up builds one ``Engine`` of the port (``tgb_tgn_dgl_tpu_torch``)
on the stream the traffic file describes, made from the seed, with the
weights made from the seed on the device; it runs ``warm_buckets`` as
``Engine.fit`` does, and warms the cell's own entry on its own shapes.
Whatever depends on the architecture goes through the plain reference
that the cell's configuration names (``spec.reference``; its interface
in ``reference/__init__.py``), held as ``Run.ref``:

* ``train_epoch`` cells: one epoch, whose first three steps the
  correctness check reads (the optimizer's first moments after step 1,
  the parameters after step 3, each step's loss, and the reference's
  ``step_record`` of the pack each step was handed), and the traffic's
  further warm-up epochs;
* ``evaluate`` cells: the traffic's train epochs; then the start of every
  val pass, made by the reference: its stream state after those epochs
  (which the program's packer has to hold, and the check compares), the
  weights made from the seed, and the model state the reference makes
  over those epochs with them (``train_epoch_state``), loaded into the
  engine and taken as its snapshot; and one val pass from it.  The
  reference's part is set-up that the program does not do, and is left
  out of ``setup_s``.

The window then runs whole calls of the same entry on the same engine
(``evaluate``: each after ``restore_stream`` of the snapshot, inside the
window) until ``seconds`` have passed; each rate is the events of every
call over the wall time from the first call's start to the last one's
end (its metrics fetch).
"""
from __future__ import annotations

import gc
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from . import check, spans, spec, trace
from .flops import count_params
from .stream import synthetic

# top-level module names a run may not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tgb_tgn_dgl_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


class Clock:
    """Set-up parts in seconds, in the order they ran; the benchmark's own
    parts (``counted=False``) are kept apart."""

    def __init__(self, start: float):
        self.start = start
        self.last = start
        self.parts: Dict[str, float] = {}
        self.uncounted: Dict[str, float] = {}

    def mark(self, name: str, counted: bool = True) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now
        if not counted:
            self.uncounted[name] = self.parts[name]

    def setup_s(self) -> float:
        """From the start to now, less the uncounted parts."""
        return (time.perf_counter() - self.start
                - sum(self.uncounted.values()))


def make_stream(traffic: dict, seed: int, preset: Optional[str] = None):
    st = traffic["stream"]
    return synthetic(preset or st["preset"], seed=seed,
                     neg_splits=tuple(st["neg_splits"]))


def program_data(stream):
    """The stream as the program's ``TemporalData``."""
    from tgb_tgn_dgl_tpu_torch.data.dataset import TemporalData
    return TemporalData(name=stream.name, src=stream.src, dst=stream.dst,
                        t=stream.t, msg=stream.msg,
                        train_mask=stream.train_mask,
                        val_mask=stream.val_mask,
                        test_mask=stream.test_mask, val_ns=stream.val_ns,
                        test_ns=stream.test_ns)


def build_libraries(torch, device) -> None:
    """Build (first run in a checkout) or load the program's libraries:
    the host packer and leveler, and on CUDA the attention kernels."""
    from tgb_tgn_dgl_tpu_torch.ops import _build
    _build.host_library("packer")
    _build.host_library("hostops")
    if device.type == "cuda":
        _build.library("attention")


class FirstSteps:
    """Wraps ``engine._train_step`` for the first ``n`` steps of the next
    epoch and records what the check compares: each step's loss, Adam's
    first moments after step 1 (the first gradient, exp_avg / (1 - β1)),
    and the parameters after step ``n``; and ``record(pack)`` of the
    device pack each step is handed (the reference's ``step_record``);
    then takes itself off."""

    def __init__(self, engine, record: Callable, n: int = 3):
        self.engine, self.record, self.n = engine, record, n
        self.orig = engine._train_step
        self.losses, self.g1, self.params = [], None, None
        self.records = []
        engine._train_step = self

    def __call__(self, pack, acc):
        self.records.append(self.record(pack))
        out = self.orig(pack, acc)
        eng = self.engine
        self.losses.append(out[0].detach().clone())
        named = list(eng.model.named_parameters())
        if len(self.losses) == 1:
            b1 = eng.optimizer.param_groups[0]["betas"][0]
            st = eng.optimizer.state
            self.g1 = {k: (st[p]["exp_avg"].clone() / (1.0 - b1)
                           if p in st else p.detach() * 0.0)
                       for k, p in named}
        if len(self.losses) == self.n:
            self.params = {k: p.detach().clone() for k, p in named}
            del eng._train_step
        return out

    def readings(self) -> dict:
        if self.params is None:
            raise RuntimeError(f"the epoch ran fewer than {self.n} steps")
        return {"losses": [float(x) for x in self.losses],
                "records": list(self.records),
                "g1": {k: v.cpu() for k, v in self.g1.items()},
                "params": {k: v.cpu() for k, v in self.params.items()}}


class Ranks:
    """Wraps ``engine._finalize`` to keep each val batch's rank counts
    (the answers of the pass) for the comparison after the window."""

    def __init__(self, engine):
        self.engine = engine
        self.orig = engine._finalize
        self.batches = []
        engine._finalize = self

    def __call__(self, acc, opt, pes, valid):
        self.batches.append((opt, pes, valid))
        return self.orig(acc, opt, pes, valid)

    def passes(self, n_batches: int) -> list:
        """Per pass, its events' (better, at-least-as-good) counts, the
        padded events of each batch left out, and the batch of each
        event."""
        out = []
        for i in range(0, len(self.batches), n_batches):
            opt, pes, blk = [], [], []
            for b, (o, p, valid) in enumerate(
                    self.batches[i:i + n_batches]):
                opt.append(o[valid].cpu().numpy())
                pes.append(p[valid].cpu().numpy())
                blk.append(np.full(len(opt[-1]), b))
            out.append((np.concatenate(opt), np.concatenate(pes),
                        np.concatenate(blk)))
        return out


class ChunkShapes:
    """Wraps ``engine._unique_eval_step`` over one val pass and records
    each batch's embed-chunk shape: (root slots R2, chunks, read rows)."""

    def __init__(self, engine):
        self.engine = engine
        self.orig = engine._unique_eval_step
        self.shapes = []
        engine._unique_eval_step = self

    def __call__(self, wire, iw, mask, valid, acc, n_chunks, n_mc):
        self.shapes.append((int(wire.root_loc.shape[0]), int(n_chunks),
                            int(wire.uniq_nid.shape[0])))
        return self.orig(wire, iw, mask, valid, acc, n_chunks, n_mc)

    def close(self):
        del self.engine._unique_eval_step


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


class Run:
    """One cell's engine, from its set-up to the program's outputs."""

    def __init__(self, cell: spec.Cell, seed: int, device: str,
                 clock: Clock, preset: Optional[str] = None,
                 traced: bool = False):
        import torch
        from tgb_tgn_dgl_tpu_torch.engine.train import Engine
        from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict
        ref = self.ref = spec.reference(cell.config, cell.traffic["entry"])
        clock.mark("import")
        self.torch, self.cell, self.seed = torch, cell, seed
        dev = self.dev = torch.device(device)
        # the configurations state float32 with TF32 off
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.zeros(1, device=dev)
        _sync(torch, dev)
        clock.mark("device")
        build_libraries(torch, dev)
        clock.mark("libraries")

        tr = self.traffic = cell.traffic
        self.entry = tr["entry"]
        self.stream = make_stream(tr, seed, preset)
        self.model = ref.model_of(cell.config, self.stream.msg.shape[1])
        clock.mark("stream")
        cfg = parse_config_dict(spec.framework_sections(cell.config, tr,
                                                        seed))
        eng = self.eng = Engine(program_data(self.stream), cfg,
                                device=device)
        clock.mark("engine")
        self.weights = ref.make_weights(self.model, seed, dev)
        eng.model.load_state_dict(self.weights)
        clock.mark("weights")
        eng.warm_buckets()
        clock.mark("warm_buckets")

        self.readings: dict = {}
        self.shapes = None
        if self.entry == "train_epoch":
            # the dropout draws start from the seed the reference's do
            eng.generator.manual_seed(ref.mask_seed(seed))
            spy = FirstSteps(eng, ref.step_record)
            for _ in range(tr["warmup_calls"]):
                eng.train_epoch()
            self.readings = spy.readings()
            del spy
        elif self.entry == "evaluate":
            for _ in range(tr["setup_train_epochs"]):
                eng.train_epoch()
            _sync(torch, dev)
            clock.mark("train_epochs")
            self.start_state, self.start_mem = ref.train_epoch_state(
                self.stream, self.model, seed, tr["batch_size"],
                tr["setup_train_epochs"], self.weights, dev)
            _sync(torch, dev)
            clock.mark("reference_state", counted=False)
            eng.model.load_state_dict(self.weights)
            self.snap = eng.snapshot_stream()
            if eng.use_memory:
                self.snap["mem_state"] = ref.program_state(
                    self.start_mem, self.snap["mem_state"])
            self.readings["packer_before"] = tuple(
                np.copy(a) if isinstance(a, np.ndarray) else a
                for a in self.snap["packer"])
            shape_spy = ChunkShapes(eng) if traced else None
            for _ in range(tr["warmup_calls"]):
                eng.restore_stream(self.snap)
                eng.evaluate(tr["split"])
            if shape_spy is not None:
                shape_spy.close()
                self.shapes = shape_spy.shapes
                del shape_spy
        else:
            raise ValueError(f"unknown entry {self.entry!r} in the traffic "
                             f"file")
        _sync(torch, dev)
        clock.mark("warmup")
        self.setup_s = clock.setup_s()

    def call(self) -> dict:
        """One call of the cell's entry; returns its trace."""
        eng = self.eng
        if self.entry == "train_epoch":
            self.events = eng.train_epoch()["events"]
            return eng.last_epoch_trace
        eng.restore_stream(self.snap)
        self.mrrs.append(eng.evaluate(self.traffic["split"]))
        self.events = int(self.stream.val_mask.sum())
        return eng.last_eval_trace

    def window(self, seconds: float) -> dict:
        """Whole calls until ``seconds`` have passed (at least one)."""
        w = {"spans": {"fetch_s": 0.0, "copy_s": 0.0, "disp_s": 0.0},
             "events": 0, "calls": 0, "batches": 0, "chunks": 0}
        self.mrrs = []
        self.ranks = Ranks(self.eng) if self.entry == "evaluate" else None
        t0 = time.perf_counter()
        w["call_s"] = []
        while True:
            t1 = time.perf_counter()
            tr_ = self.call()
            w["call_s"].append(time.perf_counter() - t1)
            w["events"] += self.events
            w["calls"] += 1
            w["batches"] += tr_["batches"]
            w["chunks"] += tr_.get("chunks", 0)
            for k in w["spans"]:
                w["spans"][k] += tr_[k]
            if time.perf_counter() - t0 >= seconds:
                break
        w["window_s"] = time.perf_counter() - t0
        w["last_batches"] = tr_["batches"]
        self.w = w
        return w

    def outputs(self) -> None:
        """Keep what the check reads of the program's outputs, on the
        host, and free the program's state."""
        eng, torch = self.eng, self.torch
        if self.entry == "evaluate":
            r = self.readings
            r["mrrs"] = self.mrrs
            r["counts"] = self.ranks.passes(self.w["last_batches"])
            r["packer_after"] = eng.packer.snapshot()
            r["mem_after"] = (type(eng.mem_state)(
                *(t.cpu() for t in eng.mem_state)) if eng.use_memory
                else None)
            del self.snap
        self.ranks = self.eng = eng = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, half_batch: bool = False,
                  still: bool = False, taus: tuple = (check.TAU,)):
        """The plain reference over what the window's entry computed; in
        ``tf32`` its matmuls in TF32 (the control); ``half_batch`` and
        ``still`` plant the faults of the reference's ``train_steps``;
        ``taus`` the score slacks of the val pass's bounds."""
        torch, tr, ref = self.torch, self.traffic, self.ref
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            if self.entry == "train_epoch":
                return ref.train_steps(self.stream, self.model, self.weights,
                                       self.seed, tr["batch_size"],
                                       self.readings["records"], self.dev,
                                       half_batch=half_batch, still=still)
            mem = (self.start_mem.clone() if self.start_mem is not None
                   else None)
            return ref.val_pass(self.stream, self.model, self.weights,
                                self.start_state.copy(), mem,
                                tr["batch_size"], self.dev, taus=taus)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def numbers(self, r, prog: Optional[dict] = None) -> Dict[str, float]:
        """The compared numbers of ``prog`` (default: the program's
        readings) against the reference result ``r``."""
        prog = self.readings if prog is None else prog
        if self.entry == "train_epoch":
            return check.train_numbers(prog, r, self.weights)
        return check.val_numbers(prog, r, self.start_state)

    def as_program(self, r) -> dict:
        """A reference result in the place of the program's readings."""
        if self.entry == "train_epoch":
            return {"losses": r.losses,
                    "g1": {k: v.cpu() for k, v in r.grads[0].items()},
                    "params": {k: v.cpu() for k, v in r.params.items()}}
        st = r.state
        opt, pes = r.counts[:, 0], r.counts[:, 1]
        blk = np.arange(len(opt)) // self.traffic["batch_size"]
        mem = (None if r.mem is None else
               self.ref.program_state(r.mem, self.readings["mem_after"]))
        return {"mrrs": [r.mrr], "counts": [(opt, pes, blk)],
                "packer_before": self.readings["packer_before"],
                "packer_after": (st.nbr, st.eid, st.t, st.clock),
                "mem_after": mem}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str, clock: Clock, preset: Optional[str] = None,
             log: Callable[[str], None] = print) -> dict:
    """One run; returns the result line's fields and the checks."""
    from tgb_tgn_dgl_tpu_torch.ops import attention
    run = Run(cell, seed, device, clock, preset, traced)
    torch, dev = run.torch, run.dev
    w = run.window(seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    log(f"window {w['window_s']:.3f} s, {w['calls']} calls, "
        f"{w['batches']} batches, {w['events']} events")
    log("calls " + " ".join(f"{x:.4f}" for x in w["call_s"]))
    result = {"attempted": w["batches"], "failed": 0,
              "memory_peak_bytes": peak, "metrics": {},
              "window_s": w["window_s"]}
    if not traced:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metric = ("train_edges_per_s" if run.entry == "train_epoch"
                  else "val_edges_per_s")
        result["metrics"] = {
            metric: {"value": w["events"] / w["window_s"],
                     "unit": units[metric]},
            "setup_s": {"value": run.setup_s, "unit": units["setup_s"]}}
    else:
        ctx = _layer_context(run, attention)
        result["device_trace"] = ctx["profile"]
        prof = ctx["profile"]
        log("profiled call: launches " + json.dumps(
            {k: v for k, v in prof["launches"].items() if v})
            + ", attention kernels in the trace " + json.dumps(
                {k[:40]: v for k, v in prof["kernel_counts"].items()
                 if "attention" in k}))
        log("profiled call: spans " + json.dumps(ctx["span_metrics"]))
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    run.outputs()
    t_ref = time.perf_counter()
    numbers = run.numbers(run.reference())
    result["reference_s"] = time.perf_counter() - t_ref
    result["numbers"] = numbers
    result["checks"] = check.judge(numbers, cell.limits)
    result["correct"] = all(c["ok"] for c in result["checks"].values())
    return result


def result_line(res: dict, traced: bool, device: dict) -> dict:
    """The run's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (with ``memory_peak_bytes``; traced, also the
    profiled call's ``busy_s`` and ``window_s``), traced a ``breakdown``,
    and last ``checks``, each compared number with its limit."""
    device = dict(device, memory_peak_bytes=int(res["memory_peak_bytes"]))
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if traced:
        prof = res["device_trace"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": trace.top(prof["kernels"]),
                             "idle_gaps": trace.top(prof["idle_gaps"])}
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in res["checks"].items()}
    return line


def _layer_context(run: Run, attention) -> dict:
    """What the per-layer readers read: the window's host spans and call
    counts, the model's sizes (the reference's ``layer_context``), the
    program's memory settings and, on train cells, its padded step shapes
    and parameter count; and one more call under the profiler, with the
    reading of the program's spans in its trace (``span_metrics``:
    ``spans.layer_metrics``, empty where the trace has no device
    events)."""
    eng, w, tr = run.eng, run.w, run.traffic
    cfg = eng.config
    ctx = {"phase": "train" if run.entry == "train_epoch" else "val",
           "window_s": w["window_s"], "spans": dict(w["spans"]),
           "calls": w["calls"], "batches": w["batches"],
           "chunks": w["chunks"], "B": tr["batch_size"],
           **run.ref.layer_context(run.model),
           "S": cfg.memory.mailbox_size, "updater": cfg.memory.memory_update}
    if run.entry == "train_epoch":
        b = eng.packer.bucket_state()[(1, False)]
        ctx.update(R=b["R"], U=b["Ub"] if eng.use_memory else 0,
                   n_params=count_params(eng.model))
    else:
        ctx.update(chunk_shapes=run.shapes,
                   M=int(eng.data.val_ns.shape[1]))
    before = dict(attention.launch_counts)
    events = trace.profile(run.torch, run.call)
    prof = ctx["profile"] = trace.read_events(events)
    prof["launches"] = {k: attention.launch_counts[k] - before[k]
                        for k in before}
    ctx["span_metrics"] = spans.layer_metrics(spans.read_spans(events), prof)
    return ctx
