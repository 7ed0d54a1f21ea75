"""Host-clock spans inside the port's loops, on the profiler's clock.

:func:`span` marks a region of the trainer, the train step, the control
plane's ``observe`` or the serve loop::

    with runtime.span("serve.decode", token=i):
        ...

It is on while a ``torch.profiler`` profile is active, and inside
:func:`recording` (tests, operators), except inside :func:`paused`. When
off it costs a check of its flags: no clock read, no ``record_function``,
no CUDA event, and the same shared no-op context every time. When on, a
span

1. enters ``torch.profiler.record_function(name)``, so that it sits in the
   profiler's trace as a ``user_annotation`` on the kernels' clock;
2. records ``(name, ids, host start and end from time.perf_counter())``
   into this module's :class:`~repro_torch.obs.tracer.SpanTracer`, on one
   track per loop (``("host", "trainer")``, ``("host", "serve")``): a
   span's track is its parent's, an outermost span's follows its name;
3. once CUDA is initialised, records a timing ``torch.cuda.Event`` on the
   current stream at entry and at exit. Nothing waits on them until
   :func:`totals` reads them.

:func:`timed` is a span that reads the host clock even when off, for the
regions the loops time anyway (``step_seconds``, ``prefill_s``): one pair
of clock reads serves both.

The dropless MoE layer (:mod:`repro_torch.models.moe`, a configuration
with ``moe_dropless``, as granite-4.0-h-small) opens ``moe.route`` (router
product, top-k, the sort by held expert and the gather of the sorted rows),
``moe.experts`` (the grouped products and the shared expert) and
``moe.combine``, inside ``train.forward`` and, in a sub-layer checkpoint's
recompute, inside ``train.backward``; the MoE's own backward runs in
``train.backward``, outside them.

:func:`count` is a counter beside the spans, on and off with them: off it
checks the flags and never touches the tensor; on it keeps a device tensor
of counts (``moe.held_routed``: the routed choices of one MoE layer call
on each held expert) with the names of the spans open around it, and
nothing waits on it. :func:`counts` reads the record (a read waits on the
device, so read it only after recording or profiling): per counter name
the ``ticks``, the ``sum`` of every count and the ``max`` single count
(the busiest held expert of any one call); with
``within="train.forward"`` only the ticks made inside that span, so that
a recompute's second count of the same choices is left out.

Inside :func:`paused` nothing records, profiler or not: the serve loop
captures its decode step into a CUDA graph there, where a span's CUDA
events would be captured too and its host times would time the capture,
not the step. The serve loop counts ``serve.graph_replays`` once a batch:
the decode steps it served by replaying that graph.

:func:`totals` sums the record by span name; :func:`reset` clears it. The
profiler's trace is the export; :func:`tracer` hands the record to
:meth:`SpanTracer.to_json` for a trace of the spans alone. Spans open and
close on the thread that drives the loop.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function

from repro_torch.obs.tracer import SpanTracer

__all__ = ["count", "counts", "enabled", "paused", "recording", "reset", "span", "timed",
           "totals", "tracer"]

try:
    from torch.autograd import profiler as _autograd_profiler

    _autograd_profiler._is_profiler_enabled

    def _profiling() -> bool:
        return _autograd_profiler._is_profiler_enabled
except AttributeError:  # a torch without the Python-side flag
    _profiling = torch._C._autograd._profiler_enabled

#: the track of an outermost span, by the first part of its name
_LOOPS = {"train": ("host", "trainer"), "serve": ("host", "serve")}

_recording = False
_paused = False
_tracer = SpanTracer()
#: position of a span among the tracer's events -> its CUDA event pair,
#: or its device seconds once read
_device: dict = {}
#: the track and name of each open span, innermost last
_open: list = []
#: each counter tick: (name, device tensor of counts, names of the open spans)
_counters: list = []


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "ids", "on", "start", "end", "_rf", "_ev", "_record", "_track")

    def __init__(self, name: str, ids: dict, on: bool) -> None:
        self.name, self.ids, self.on = name, ids, on

    def __enter__(self) -> "_Span":
        if self.on:
            self._track = _open[-1][0] if _open else _LOOPS.get(
                self.name.split(".")[0], ("host", self.name.split(".")[0]))
            _open.append((self._track, self.name))
            self._record = (_tracer, _device)
            self._rf = record_function(self.name)
            self._rf.__enter__()
            self._ev = None
            if torch.cuda.is_initialized():
                self._ev = torch.cuda.Event(enable_timing=True)
                self._ev.record()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        if self.on:
            tr, device = self._record
            if self._ev is not None:
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
            self._rf.__exit__(None, None, None)
            _open.pop()
            tr.span(self._track, self.name, self.start, self.end, self.ids)
            if self._ev is not None:
                device[len(tr) - 1] = (self._ev, ev1)
        return False

    @property
    def seconds(self) -> float:
        """Host seconds from entry to exit."""
        return self.end - self.start


def _on() -> bool:
    return not _paused and (_recording or _profiling())


def count(name: str, value: torch.Tensor) -> None:
    """Keep ``value`` (a tensor of counts) under ``name`` while spans
    record; when off, a check of the flags."""
    if _on():
        _counters.append((name, value.detach(), tuple(n for _, n in _open)))


def counts(within: str | None = None) -> dict[str, dict]:
    """For each counter name: ``ticks``, ``sum`` (of every count of every
    tick) and ``max`` (the largest single count), over the ticks made
    while a span named ``within`` was open (None: every tick)."""
    out: dict[str, dict] = {}
    for name, value, opened in _counters:
        if within is not None and within not in opened:
            continue
        t = out.setdefault(name, {"ticks": 0, "sum": 0, "max": 0})
        v = value.cpu()
        t["ticks"] += 1
        t["sum"] += int(v.sum())
        t["max"] = max(t["max"], int(v.max()))
    return out


def enabled() -> bool:
    """True while spans record: under a profiler, or inside :func:`recording`,
    and not inside :func:`paused`."""
    return _on()


def span(name: str, **ids):
    """A context manager around one region; ``ids`` (step, token, slot)
    tie it to its request."""
    if _on():
        return _Span(name, ids, True)
    return _NULL


def timed(name: str, **ids) -> _Span:
    """:func:`span` whose entry and exit always read the host clock; its
    ``seconds`` is the region's host time, on or off."""
    return _Span(name, ids, _on())


@contextmanager
def recording():
    """Spans record inside this context without a profiler."""
    global _recording
    saved, _recording = _recording, True
    try:
        yield
    finally:
        _recording = saved


@contextmanager
def paused():
    """No span or counter records inside this context, even under a
    profiler or inside :func:`recording`."""
    global _paused
    saved, _paused = _paused, True
    try:
        yield
    finally:
        _paused = saved


def tracer() -> SpanTracer:
    """The record: every finished span, host times in ``perf_counter`` seconds."""
    return _tracer


def reset() -> None:
    """Clear the record (spans still open close into the old one)."""
    global _tracer, _device, _counters
    _tracer, _device, _counters = SpanTracer(), {}, []


def _device_seconds(i: int) -> float | None:
    got = _device.get(i)
    if got is None or isinstance(got, float):
        return got
    start, end = got
    end.synchronize()
    _device[i] = start.elapsed_time(end) / 1e3
    return _device[i]


def totals() -> dict[str, dict]:
    """For each span name: ``count``; ``host_s``; ``self_s``, the host
    seconds less those of its children on the same track; and
    ``device_s``, the summed time between each span's two CUDA events
    (None where no span of the name has them: on the CPU)."""
    by_track: dict = {}
    for i, (ph, track, name, ts, dur, _) in enumerate(_tracer.events()):
        if ph == "X":
            by_track.setdefault(track, []).append((ts, -(ts + dur), -i, name))
    out: dict[str, dict] = {}
    for spans in by_track.values():
        # Parents sort before their children: earlier start, later end, and
        # (for equal intervals) recorded later, since a span is recorded as
        # it closes.
        spans.sort()
        children = [0.0] * len(spans)
        stack: list[int] = []
        for k, (ts, neg_end, _, _) in enumerate(spans):
            while stack and spans[stack[-1]][1] > neg_end:   # ends before this one
                stack.pop()
            if stack:
                children[stack[-1]] += -neg_end - ts
            stack.append(k)
        for k, (ts, neg_end, neg_i, name) in enumerate(spans):
            t = out.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                      "device_s": None})
            host = -neg_end - ts
            t["count"] += 1
            t["host_s"] += host
            t["self_s"] += host - children[k]
            dev = _device_seconds(-neg_i)
            if dev is not None:
                t["device_s"] = (t["device_s"] or 0.0) + dev
    return out
