"""optimizer_pct.train: AdamW's share of a traced step's device time: the
device seconds of span ``train.optimizer`` (the mean over slots and
``adamw.update``) over those of ``train.compute`` (the region
``FalconTrainer.step_seconds`` times), each between the CUDA events
recorded on the stream at the span's entry and exit."""
from portbench import spans


def read(ctx):
    if ctx.get("driver") != "train":
        return None
    t = spans.totals()
    opt = t.get("train.optimizer", {}).get("device_s")
    compute = t.get("train.compute", {}).get("device_s")
    if opt is None or not compute:
        return None
    return 100.0 * opt / compute
