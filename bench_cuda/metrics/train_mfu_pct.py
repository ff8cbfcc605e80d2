"""``train_mfu_pct``: the whole train step's share of the card's fp32 peak
(67 TFLOP/s, TF32 off) over the untraced window: the FLOPs of one step
by the frozen cost model (``bench_cuda/flops.py::flagship_step_cost`` at
the batch, the packer's padded R, Kp and read-set rows, forward,
backward and Adam) times the window's steps, over its wall time."""
from bench_cuda.flops import H100_PEAK_FP32_FLOPS, flagship_step_cost


def read(ctx):
    if ctx["phase"] != "train":
        return None
    cost = flagship_step_cost(B=ctx["B"], R=ctx["R"], Kp=ctx["Kp"],
                              F=ctx["F"], D=ctx["D"], H=ctx["H"], M=1,
                              U=ctx["U"], S=ctx["S"], updater=ctx["updater"],
                              n_params=ctx["n_params"], train=True,
                              act_bytes=4)
    return (100.0 * ctx["batches"] * cost["flops"] / ctx["window_s"]
            / H100_PEAK_FP32_FLOPS)
