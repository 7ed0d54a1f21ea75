"""expert_gemm_roofline.hybrid_train: the least time for the routed
experts' products of the traced steps at the card's bfloat16 peak, over
the time the grouped-product kernels ran in the trace.

The products' FLOPs are those of the cell's architecture
(``expert_gemm_flops`` of ``portbench/reference/arch/granitemoehybrid.py``:
2 * 3 * d * expert width per held choice per forward, over the forward, its
recompute and a backward of twice the forward) for the held choices that
the port's counter ``moe.held_routed`` counted inside the ``train.forward``
spans, so that the recompute's count is not added twice. The kernels are
``torch._grouped_mm``'s on the card: CUTLASS grouped GEMMs, whose names
hold ``GroupProblemShape``, and the ``prepare_grouped_gemm_data`` kernels
that set up their problem sizes. The configuration read is that of the one
cell this metric lists."""
from portbench import bench
from portbench.reference import weights
from portbench.yardstick import PEAK_BF16_FLOPS

CELL = "granite-4.0-h-small.train-8k"
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def held_choices() -> int | None:
    """The held choices the forward passes of the traced steps routed, or
    None where the port has no such counter."""
    try:
        from repro_torch.obs import runtime
    except ImportError:
        return None
    if not hasattr(runtime, "counts"):
        return None
    return runtime.counts(within="train.forward").get("moe.held_routed", {}).get("sum")


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "train" or not t:
        return None
    kernel_s = sum(s for name, s in t["by_op"].items() if any(k in name for k in KERNELS))
    held = held_choices()
    if kernel_s <= 0 or not held:
        return None
    c = bench.cell(CELL)
    sz = weights.sizes(c.config, c.root)
    return 100.0 * sz["arch"].expert_gemm_flops(sz, held) / kernel_s / PEAK_BF16_FLOPS
