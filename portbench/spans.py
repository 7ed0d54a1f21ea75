"""What the per-layer metrics of the port's spans read: the span totals
of :mod:`repro_torch.obs.runtime` after a traced run. Spans record only
while the profiler is on, so the totals hold the traced steps or batch
alone. A port without those spans gives an empty record, and the metrics
that read it are left out of the result line."""


def totals() -> dict:
    """``repro_torch.obs.runtime.totals()``, or ``{}`` where the port has
    no such module."""
    try:
        from repro_torch.obs import runtime
    except ImportError:
        return {}
    return runtime.totals()


def ms_per(names, unit: str, field: str):
    """1000 times the summed ``field`` (``host_s`` or ``device_s``) of the
    spans ``names`` over the count of spans ``unit``; None where the record
    has no ``unit`` span or no value of ``field`` for any of ``names``."""
    t = totals()
    n = t.get(unit, {}).get("count", 0)
    got = [t[k][field] for k in names if k in t and t[k][field] is not None]
    if not n or not got:
        return None
    return 1e3 * sum(got) / n
