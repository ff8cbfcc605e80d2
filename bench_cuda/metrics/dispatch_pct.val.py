"""``dispatch_pct.val``: the share of the val window's wall time the
program spent in ``disp_s``, the dispatch of the expansion and the step
(train) or the embed and score chunks (val), summed from the Engine's
``last_eval_trace`` over every call of the untraced window."""


def read(ctx):
    if ctx["phase"] != "val":
        return None
    return 100.0 * ctx["spans"]["disp_s"] / ctx["window_s"]
