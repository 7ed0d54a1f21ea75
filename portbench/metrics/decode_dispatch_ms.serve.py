"""decode_dispatch_ms.serve: host milliseconds a traced decode step takes
to enqueue its work (span ``serve.dispatch``: the ``decode(...)`` call,
before the synchronise), a ``serve.dispatch`` span."""
from portbench import spans


def read(ctx):
    if ctx.get("driver") != "serve":
        return None
    return spans.ms_per(("serve.dispatch",), "serve.dispatch", "host_s")
