"""moe_pct.hybrid_train: the MoE layers' share of a traced step's device
time: the device seconds of the port's spans ``moe.route`` (router
product, top-k, sort, gather of the sorted rows), ``moe.experts`` (the
grouped expert products and the shared expert) and ``moe.combine``, over
those of ``train.compute`` (the region ``FalconTrainer.step_seconds``
times), each between the CUDA events recorded on the stream at the span's
entry and exit. The ``moe.*`` spans open in the forward and in its
recompute; the MoE's backward stays inside ``train.backward``."""
from portbench import spans

MOE = ("moe.route", "moe.experts", "moe.combine")


def read(ctx):
    if ctx.get("driver") != "train":
        return None
    t = spans.totals()
    moe = [t[k]["device_s"] for k in MOE if k in t and t[k]["device_s"] is not None]
    compute = t.get("train.compute", {}).get("device_s")
    if not moe or not compute:
        return None
    return 100.0 * sum(moe) / compute
