"""``attn_roofline_pct.train``: the attention kernels' share of their
roofline over one profiled train epoch: the least time their launches
could take (the larger of bytes over 3.35 TB/s and operations over 67
TFLOP/s, ``bench_cuda/attn_bytes.py``, at the packer's padded R and Kp,
each launch counted by ``ops/attention.py``'s ``launch_counts``) over
their device time in the trace. The bytes are what the kernels must
move, each input read once and each output written once."""
from bench_cuda.attn_bytes import kernel_bound_s

KERNEL_NAMES = ("attention_fwd_kernel", "attention_bwd_kernel")


def read(ctx):
    if ctx["phase"] != "train":
        return None
    prof = ctx["profile"]
    launches = prof["launches"]
    if launches.get("attention_fwd_infer"):
        return None
    bound = sum(n * kernel_bound_s(e, ctx["R"], ctx["Kp"], ctx["H"])
                for e, n in launches.items() if n)
    spent = sum(s for k, s in prof["kernels"].items()
                if any(n in k for n in KERNEL_NAMES))
    # a trace that lost some of the launches would read the share high
    traced = sum(c for k, c in prof["kernel_counts"].items()
                 if any(n in k for n in KERNEL_NAMES))
    if traced != sum(launches.values()):
        return None
    if bound <= 0.0 or spent <= 0.0:
        return None
    return 100.0 * bound / spent
