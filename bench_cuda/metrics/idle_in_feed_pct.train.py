"""``idle_in_feed_pct.train``: the share of one profiled train epoch in
which the device sat idle while the main thread was inside a ``feed``
span (the packer's fetch and the wire's copy): the card waiting on the
host packer (``bench_cuda/spans.py::layer_metrics``).  Absent without a
device trace."""


def read(ctx):
    if ctx["phase"] != "train":
        return None
    return ctx["span_metrics"].get("idle_in_feed_pct")
