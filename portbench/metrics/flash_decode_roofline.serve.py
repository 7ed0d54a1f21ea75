"""flash_decode_roofline.serve: the least time for the bytes the traced
batch's ``flash_decode`` launches must move (q, the valid K and V rows and
the output, each once) at the card's 3.35 TB/s, over the time its kernel
(``decode_kernel``) ran in the trace."""
from portbench.yardstick import PEAK_HBM_BYTES


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "serve" or not t:
        return None
    kernel_s = sum(s for name, s in t["by_op"].items() if "decode_kernel<" in name)
    if kernel_s <= 0:
        return None
    return 100.0 * ctx["decode_bytes_per_batch"] / PEAK_HBM_BYTES / kernel_s
