"""``attn_roofline_pct.val``: the attention kernel's share of its roofline
over one profiled val pass: the least time of its launches (one
``attention_fwd_infer`` an embed chunk, at each batch's chunk of its
padded root slots, ``bench_cuda/attn_bytes.py``) over their device time
in the trace. Read only when the launches counted by
``ops/attention.py`` are the chunks the pass recorded."""
from bench_cuda.attn_bytes import kernel_bound_s

KERNEL_NAMES = ("attention_fwd_kernel", "attention_bwd_kernel")


def read(ctx):
    if ctx["phase"] != "val" or not ctx.get("chunk_shapes"):
        return None
    prof = ctx["profile"]
    launches = prof["launches"]
    shapes = ctx["chunk_shapes"]
    if prof["launches"].get("attention_fwd_infer") != sum(
            n for _, n, _ in shapes):
        return None
    bound = sum(n * kernel_bound_s("attention_fwd_infer", r // n, ctx["Kp"],
                                   ctx["H"]) for r, n, _ in shapes)
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
