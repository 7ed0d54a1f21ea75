"""falcon_ms.serve: host milliseconds a traced decode step spends in
FALCON (span ``falcon.observe``: the injector, the performance model's
iteration time and ``FalconDetect.observe``) while the card waits, over
the ``serve.decode`` spans."""
from portbench import spans


def read(ctx):
    if ctx.get("driver") != "serve":
        return None
    return spans.ms_per(("falcon.observe",), "serve.decode", "host_s")
