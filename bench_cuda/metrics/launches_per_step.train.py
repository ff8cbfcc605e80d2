"""``launches_per_step.train``: the runtime calls that enqueue device work
(kernel launches, async copies and sets) made under ``step`` spans,
forward and backward, per step of one profiled train epoch
(``bench_cuda/spans.py::layer_metrics``).  Absent without a device
trace."""


def read(ctx):
    if ctx["phase"] != "train":
        return None
    return ctx["span_metrics"].get("launches_per_step")
