"""``pack_wait_pct.val``: the share of the val window's wall time the
program spent in ``fetch_s``, the wait of the main thread for the
packer's thread (the packer's fetch), summed from the Engine's
``last_eval_trace`` over every call of the untraced window."""


def read(ctx):
    if ctx["phase"] != "val":
        return None
    return 100.0 * ctx["spans"]["fetch_s"] / ctx["window_s"]
