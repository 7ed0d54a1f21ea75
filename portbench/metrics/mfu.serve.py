"""mfu.serve: the model FLOPs of the window's batches (2 * matmul
parameters * every prompt and generated token, the prompt's causal
attention, each decode step's products with its cache) over the window's
seconds, as a share of the card's bfloat16 peak."""
from portbench.yardstick import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("driver") != "serve" or not ctx["batches"]:
        return None
    return 100.0 * ctx["batches"] * ctx["flops_per_batch"] / ctx["window_s"] / PEAK_BF16_FLOPS
