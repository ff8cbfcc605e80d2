"""``idle_in_step_pct.train``: the share of one profiled train epoch in
which the device sat idle while the main thread was inside a ``step``
span (its children included): the step's own dispatch not keeping the
card fed (``bench_cuda/spans.py::layer_metrics``).  Absent without a
device trace."""


def read(ctx):
    if ctx["phase"] != "train":
        return None
    return ctx["span_metrics"].get("idle_in_step_pct")
