"""prefill_ms.serve: device milliseconds of a traced batch's prefill: the
time between the CUDA events recorded at the entry and exit of span
``serve.prefill`` (the synchronised region ``ServeResult.prefill_s``
times), a ``serve.prefill`` span."""
from portbench import spans


def read(ctx):
    if ctx.get("driver") != "serve":
        return None
    return spans.ms_per(("serve.prefill",), "serve.prefill", "device_s")
