"""mfu.train: the model FLOPs of the window's training steps (the
yardstick's count from the shapes, no recompute) over the window's seconds,
as a share of the card's bfloat16 peak."""
from portbench.yardstick import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("driver") != "train" or not ctx["steps"]:
        return None
    return 100.0 * ctx["steps"] * ctx["flops_per_step"] / ctx["window_s"] / PEAK_BF16_FLOPS
