"""idle_pct.serve: the share of a batch's wall time in which no kernel,
copy or set runs on the device: one minus the device seconds of a traced
batch (the union of its operations in the profiler's trace, which the
profiler's host cost does not stretch) over the untraced window's wall
seconds a batch."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "serve" or not t or t["busy_s"] <= 0 or not ctx["batches"]:
        return None
    busy = t["busy_s"] / ctx["trace_units"]
    wall = ctx["window_s"] / ctx["batches"]
    return 100.0 * (1.0 - busy / wall)
