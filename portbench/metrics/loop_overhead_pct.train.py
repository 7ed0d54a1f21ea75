"""loop_overhead_pct.train: the share of the window outside the trainer's
own synchronised step timings (``FalconTrainer.step_seconds``): batch
build, host-to-device copy, performance model, injector and ``observe``."""


def read(ctx):
    if ctx.get("driver") != "train" or not ctx["steps"]:
        return None
    return 100.0 * (1.0 - ctx["step_s"] / ctx["window_s"])
