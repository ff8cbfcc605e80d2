"""``wire_copy_pct.train``: the share of the train window's wall time the
program spent in ``copy_s``, the copy of each wire to the device
(wire_to_device), summed from the Engine's ``last_epoch_trace`` over
every call of the untraced window."""


def read(ctx):
    if ctx["phase"] != "train":
        return None
    return 100.0 * ctx["spans"]["copy_s"] / ctx["window_s"]
