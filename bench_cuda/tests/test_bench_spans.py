"""The spans' reading of a device trace (``bench_cuda/spans.py``) on a
hand-built chrome trace: kernels put down through their launches on the
main thread and on a second (autograd) thread, idle gaps inside ``step``,
inside ``feed`` and outside both, the trace's existing reading
(``trace.read_events``) and per-layer metrics unchanged by the span
events, and the readers of the per-layer metrics over the spans'
reading."""
import copy

import pytest

from conftest import small_cell

from bench_cuda import spans, spec, trace

MAIN = dict(pid=1, tid=10)
AUTOGRAD = dict(pid=1, tid=20)
CARD = dict(pid=0, tid=7)


def _x(cat, name, ts, end, where, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=end - ts, args=args,
                **where)


def _launch(name, corr, ts, k0, k1, kernel="k", cat="kernel", where=MAIN):
    """A runtime call on ``where`` and the device event it launched."""
    return [_x("cuda_runtime", name, ts, ts + 5, where, correlation=corr),
            _x(cat, kernel, k0, k1, CARD, correlation=corr)]


def _trace(with_spans=True):
    """A window [0, 1000] us: one fed step with its memory, embedding and
    backward, torch's own annotation inside ``step.adam``, and a kernel
    with no correlation id."""
    span = [("feed", 10, 100), ("feed.fetch", 20, 60), ("feed.copy", 70, 90),
            ("step", 100, 600), ("step.expand", 110, 150),
            ("step.memory.apply", 160, 200), ("step.embed", 210, 300),
            ("step.backward", 310, 500), ("step.adam", 510, 560),
            ("feed", 600, 650)]
    ev = [_x("user_annotation", trace.WINDOW, 0, 1000, MAIN)]
    if with_spans:
        ev += [_x("user_annotation", n, a, b, MAIN) for n, a, b in span]
        ev.append(_x("user_annotation", "Optimizer.step#Adam.step", 515, 555,
                     MAIN))
    ev += [
        # forward ops (Fwd thread id 0) and the backward nodes of their
        # sequence numbers on the autograd thread; an op that makes no
        # node carries the number the next node takes
        _x("cpu_op", "aten::view", 72, 74, MAIN, **{
            "Sequence number": 5, "Fwd thread id": 0}),
        _x("cpu_op", "aten::mm", 165, 190, MAIN, **{
            "Sequence number": 5, "Fwd thread id": 0}),
        _x("cpu_op", "aten::bmm", 220, 280, MAIN, **{
            "Sequence number": 9, "Fwd thread id": 0}),
        _x("cpu_op", "autograd::engine::evaluate_function: BmmBackward0",
           320, 400, AUTOGRAD, **{"Sequence number": 9, "Fwd thread id": 1}),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           400, 450, AUTOGRAD, **{"Sequence number": 5, "Fwd thread id": 1}),
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "torch::autograd::AccumulateGrad", 455, 470, AUTOGRAD),
        _x("cuda_runtime", "cudaStreamSynchronize", 900, 950, MAIN,
           correlation=99),
        _x("kernel", "orphan", 482, 484, CARD),
    ]
    ev += _launch("cudaLaunchKernel", 8, 5, 8, 12)
    ev += _launch("cudaMemcpyAsync", 1, 75, 80, 95, "Memcpy HtoD",
                  "gpu_memcpy")
    ev += _launch("cudaLaunchKernel", 2, 170, 175, 200, "gru")
    ev += _launch("cudaLaunchKernel", 3, 230, 235, 300,
                  "attention_fwd_kernel")
    ev += _launch("cudaLaunchKernel", 4, 520, 525, 545, "adam")
    ev += _launch("cudaLaunchKernel", 5, 330, 335, 420,
                  "attention_bwd_kernel", where=AUTOGRAD)
    ev += _launch("cuLaunchKernel", 6, 405, 420, 470, "gru_bwd",
                  where=AUTOGRAD)
    ev += _launch("cudaLaunchKernel", 7, 460, 470, 480, "acc_grad",
                  where=AUTOGRAD)
    return ev


def test_kernels_go_to_the_span_that_launched_them():
    r = spans.read_spans(_trace())
    us = 1e-6
    assert r["steps"] == 1
    dev = {k: {s: round(v / us, 6) for s, v in d.items()}
           for k, d in r["span_device_s"].items()}
    assert dev == {
        "outside": {"fwd": 4 + 2, "bwd": 0},        # before any span; orphan
        "feed.copy": {"fwd": 15, "bwd": 0},
        "step.memory.apply": {"fwd": 25, "bwd": 50},
        "step.embed": {"fwd": 65, "bwd": 85},
        "step.backward": {"fwd": 10, "bwd": 0},     # AccumulateGrad: no seq
        "step.adam": {"fwd": 20, "bwd": 0}}         # torch's own annotation
    assert r["span_launches"] == {
        "outside": {"fwd": 1, "bwd": 0}, "feed.copy": {"fwd": 1, "bwd": 0},
        "step.memory.apply": {"fwd": 1, "bwd": 1},
        "step.embed": {"fwd": 1, "bwd": 1},
        "step.backward": {"fwd": 1, "bwd": 0},
        "step.adam": {"fwd": 1, "bwd": 0}}
    assert r["span_kernels"]["step.embed:bwd"] == {
        "attention_bwd_kernel": pytest.approx(85 * us)}
    # every device event of the window is put down somewhere
    base = trace.read_events(_trace())
    assert sum(sum(d.values()) for d in r["span_device_s"].values()) == \
        pytest.approx(sum(base["kernels"].values()))
    m = spans.layer_metrics(r, base)
    assert m["memory_device_ms"] == pytest.approx(75e-3)
    assert m["launches_per_step"] == 6
    assert m["outside_busy_pct"] == pytest.approx(100 * 6 / 276)


def test_idle_gaps_inside_step_inside_feed_and_outside():
    r = spans.read_spans(_trace())
    idle = {k: round(v * 1e6, 6) for k, v in r["span_idle_s"].items()}
    # each gap split where the innermost span changes: [12, 80] is feed,
    # feed.fetch, feed again and feed.copy; [545, 1000] runs out of
    # step.adam through step and the last feed to the window's end
    assert idle == {"outside": 8 + 350, "feed": 18 + 5 + 50,
                    "feed.fetch": 40, "feed.copy": 10,
                    "step": 10 + 10 + 10 + 10 + 10 + 40, "step.expand": 40,
                    "step.memory.apply": 15, "step.embed": 25,
                    "step.backward": 25 + 2 + 16, "step.adam": 15 + 15}
    base = trace.read_events(_trace())
    m = spans.layer_metrics(r, base)
    assert m["idle_in_feed_pct"] == pytest.approx(12.3)
    assert m["idle_in_step_pct"] == pytest.approx(24.3)
    assert m["idle_outside_pct"] == pytest.approx(35.8)
    # the three shares make the device's idle share
    ctx = {"phase": "train", "profile": base}
    idle_pct = spec.metric_reader("device_idle_pct.train")(ctx)
    assert idle_pct == pytest.approx(72.4)
    assert (m["idle_in_step_pct"] + m["idle_in_feed_pct"]
            + m["idle_outside_pct"]) == pytest.approx(idle_pct, abs=1e-9)


def test_existing_readings_unchanged_by_span_events():
    events = {s: _trace(s) for s in (True, False)}
    with_spans, without = (trace.read_events(events[s]) for s in (True,
                                                                  False))
    assert with_spans == without
    cell = small_cell("tgn_memory.wiki.train_b8000")
    values = []
    for s, prof in ((True, with_spans), (False, without)):
        ctx = {"phase": "train", "window_s": 2.0, "calls": 2, "batches": 28,
               "chunks": 0, "B": 8000, "R": 24576, "Kp": 43, "F": 172,
               "D": 100, "H": 8, "memory": True, "S": 1, "updater": "gru",
               "U": 20000, "n_params": 300000,
               "spans": {"fetch_s": 0.2, "copy_s": 0.1, "disp_s": 1.2},
               "profile": dict(prof, launches={"attention_fwd": 1,
                                               "attention_bwd": 1}),
               "span_metrics": spans.layer_metrics(
                   spans.read_spans(events[s]), prof)}
        values.append({m["name"]: spec.metric_reader(m["name"])(ctx)
                       for m in cell.per_layer})
    # the readers of the spans' reading read it only where the trace has
    # spans; every other reader reads the same either way
    by_span = {k for k in values[0] if k.split(".")[0] in SPAN_METRICS}
    old = {k: v for k, v in values[0].items() if k not in by_span}
    assert len(old) == 6 and None not in old.values()
    assert old == {k: values[1][k] for k in old}
    assert len(by_span) == 4
    assert all(values[0][k] is not None and values[1][k] is None
               for k in by_span)


# each span metric's reader and its reading of ``_trace()`` (and of it
# with no sequence numbers, where the device time has no owner)
SPAN_METRICS = {"memory_device_ms": (75e-3, None),
                "launches_per_step": (6, 6),
                "idle_in_step_pct": (24.3, 24.3),
                "idle_in_feed_pct": (12.3, 12.3)}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_readers(name):
    read = spec.metric_reader(name + ".train")
    ev = _trace()
    seqless = copy.deepcopy(ev)
    for e in seqless:
        e["args"].pop("Sequence number", None)
    for events, want in zip((ev, seqless), SPAN_METRICS[name]):
        base = trace.read_events(events)
        ctx = {"phase": "train", "span_metrics": spans.layer_metrics(
            spans.read_spans(events), base)}
        got = read(ctx)
        assert got == (None if want is None else pytest.approx(want))
        # another phase, or a trace with no device events: absent, not 0
        assert read(dict(ctx, phase="val")) is None
    no_device = [e for e in ev if e["cat"] not in trace.DEVICE_CATS]
    base = trace.read_events(no_device)
    assert read({"phase": "train", "span_metrics": spans.layer_metrics(
        spans.read_spans(no_device), base)}) is None


@pytest.mark.parametrize("drop", ["correlation", "spans", "sequence"])
def test_reading_is_none_without_what_it_reads(drop):
    ev = copy.deepcopy(_trace(with_spans=drop != "spans"))
    for e in ev:
        if drop == "correlation":
            e["args"].pop("correlation", None)
        if drop == "sequence":
            e["args"].pop("Sequence number", None)
    r = spans.read_spans(ev)
    base = trace.read_events(ev)
    if drop == "sequence":
        # the idle split and the launches stand; the device time by span
        # cannot put the backward down
        assert r["span_device_s"] is None
        assert "memory_device_ms" not in spans.layer_metrics(r, base)
        assert spans.layer_metrics(r, base)["launches_per_step"] == 6
    else:
        assert r is None and spans.layer_metrics(r, base) == {}
