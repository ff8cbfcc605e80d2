"""``memory_device_ms.train``: the device milliseconds a train step spends
in the memory layer, over one profiled train epoch: what the spans
``step.memory.apply`` and ``step.memory.commit`` launched, forward and
the backward of their forward ops, over the epoch's ``step`` spans
(``bench_cuda/spans.py::layer_metrics``).  Absent where the trace puts
no device time down to a span (no device trace, or no sequence
numbers)."""


def read(ctx):
    if ctx["phase"] != "train":
        return None
    return ctx["span_metrics"].get("memory_device_ms")
