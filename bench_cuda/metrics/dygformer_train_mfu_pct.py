"""``dygformer_train_mfu_pct``: the whole DyGFormer train step's share of
the card's fp32 peak (67 TFLOP/s, TF32 off) over the untraced window: the
FLOPs of one step by the frozen cost model
(``bench_cuda/dygformer_flops.py::dygformer_step_cost``: forward, backward
and Adam at the traffic's batch, one negative an event, the model's sizes
from ``reference/dygformer.py::layer_context``, the program's parameter
count) times the window's steps, over its wall time.  Absent where the
context holds no DyGFormer sizes."""
from bench_cuda.dygformer_flops import dygformer_step_cost
from bench_cuda.flops import H100_PEAK_FP32_FLOPS


def read(ctx):
    if ctx["phase"] != "train" or "channel_width" not in ctx:
        return None
    cost = dygformer_step_cost(
        B=ctx["B"], M=1, L=ctx["L"], patch=ctx["patch"],
        C=ctx["channel_width"], layers=ctx["layers"],
        node_dim=ctx["node_dim"], edge_dim=ctx["F"],
        time_dim=ctx["time_dim"], n_params=ctx["n_params"], train=True)
    return (100.0 * ctx["batches"] * cost["flops"] / ctx["window_s"]
            / H100_PEAK_FP32_FLOPS)
