"""``val_mfu_pct``: the val pass's share of the card's fp32 peak (67
TFLOP/s, TF32 off) over the untraced window: per pass, by the frozen
cost model (``bench_cuda/flops.py::flagship_step_cost``, forward only),
each batch's embed chunks at their padded root slots, and its scoring of
every event's source, positive and M negatives with its memory's read
rows; times the window's passes, over its wall time."""
from bench_cuda.flops import H100_PEAK_FP32_FLOPS, flagship_step_cost


def read(ctx):
    if ctx["phase"] != "val" or not ctx.get("chunk_shapes"):
        return None
    per_pass = 0.0
    for r2, n, u in ctx["chunk_shapes"]:
        embed = flagship_step_cost(B=0, R=r2 // n, Kp=ctx["Kp"], F=ctx["F"],
                                   D=ctx["D"], H=ctx["H"], M=0, U=0,
                                   train=False, act_bytes=4)
        score = flagship_step_cost(B=ctx["B"], R=0, Kp=ctx["Kp"], F=ctx["F"],
                                   D=ctx["D"], H=ctx["H"], M=ctx["M"],
                                   U=u if ctx["memory"] else 0, S=ctx["S"],
                                   updater=ctx["updater"], train=False,
                                   act_bytes=4)
        per_pass += n * embed["flops"] + score["flops"]
    return (100.0 * ctx["calls"] * per_pass / ctx["window_s"]
            / H100_PEAK_FP32_FLOPS)
