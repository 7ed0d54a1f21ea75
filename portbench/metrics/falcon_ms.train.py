"""falcon_ms.train: host milliseconds a traced training step spends in
FALCON: the injector, the performance model's iteration time and the
modelled clock (span ``falcon.model``), and ``ControlPlane.observe`` with
the mirroring of its results (``falcon.observe``), over the
``train.step`` spans."""
from portbench import spans


def read(ctx):
    if ctx.get("driver") != "train":
        return None
    return spans.ms_per(("falcon.model", "falcon.observe"), "train.step", "host_s")
