"""A profiler trace of a few steps, reduced to what the result line carries.

:func:`profile` runs a function under ``torch.profiler`` (CPU and CUDA
activities), exports the trace to ``$TMPDIR`` and reads it back:

* ``window_s``: from the first host operation's start to the last event's
  end;
* ``busy_s``: the union of the device's kernels, copies and sets within it;
* ``device_ops``: the ten device operations that took the most time, summed
  by name;
* ``idle_gaps``: the device's idle intervals, each named by the innermost
  host operation running at its middle, summed by that name, the ten
  largest.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}
TOP = 10


def profile(fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(tempfile.gettempdir(), "portbench_trace.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    return reduce(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host, starts, outer, t) -> str:
    """The name of the latest-started host operation running at ``t``:
    among the last few thousand to start before it, else among the long
    ones."""
    i = bisect.bisect_right(starts, t)
    for h in reversed(host[max(0, i - 4096):i]):
        if h[1] >= t:
            return h[2]
    covering = [h for h in outer if h[0] <= t <= h[1]]
    return max(covering)[2] if covering else "(no host operation)"


def reduce(events: list[dict]) -> dict:
    """The reduction of a Chrome trace's complete events (times in µs)."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
        if e.get("cat") in DEVICE_CATS:
            dev.append(span)
        elif e.get("cat") in HOST_CATS:
            host.append(span)
    if not dev or not host:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "by_op": {}, "idle_gaps": []}
    start = min(a for a, _, _ in host)
    end = max(max(b for _, b, _ in host), max(b for _, b, _ in dev))
    busy = _merge([(max(a, start), min(b, end)) for a, b, _ in dev])
    by_op = defaultdict(float)
    for a, b, name in dev:
        by_op[name] += (b - a) / 1e6
    gaps, t = [], start
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if end > t:
        gaps.append((t, end))
    host.sort()
    starts = [h[0] for h in host]
    outer = [h for h in host if h[1] - h[0] >= 1e4]   # 10 ms and longer
    by_host = defaultdict(float)
    for a, b in gaps:
        by_host[_innermost(host, starts, outer, (a + b) / 2)] += (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (end - start) / 1e6,
        "device_ops": top(by_op),
        "by_op": dict(by_op),
        "idle_gaps": top(by_host),
    }
