"""``device_idle_pct.val``: the share of one profiled val pass in which no
kernel, copy or set ran on the device (torch.profiler's trace)."""


def read(ctx):
    if ctx["phase"] != "val":
        return None
    prof = ctx["profile"]
    if prof["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
