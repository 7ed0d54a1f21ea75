"""Simulated-clock span tracer with Chrome trace-event export.

:class:`SpanTracer` records *what the control plane did and when* on the
campaign's simulated clock: nested spans (``begin``/``end`` or the direct
``span``), instants, and counter samples, each on a named track. Tracks
are ``(process, thread)`` string pairs — the exporter assigns stable
pid/tid numbers in first-use order, so identical runs produce identical
traces byte for byte (the committed sidecars are regenerated and
compared byte for byte).

Export is the Chrome trace-event JSON format (``{"traceEvents": [...]}``,
phases ``X``/``i``/``C``/``M``) — drop ``<name>.trace.json`` into
Perfetto or ``chrome://tracing`` to browse a campaign's control-plane
timeline: tick cadence, watchdog silence windows, executor attempt/retry
cycles, per-job fault episodes.

Timestamps are seconds of whatever clock the caller reads; the exporter
converts to integer microseconds. The control plane and the campaigns
record simulated seconds, and nothing here reads a wall clock, so their
tracing never perturbs the traced run. :mod:`repro_torch.obs.runtime`
records the port's loops into a tracer of its own on the host clock
(``time.perf_counter``).
"""
from __future__ import annotations

import json

__all__ = ["SpanTracer", "TraceError"]


class TraceError(RuntimeError):
    """Span nesting violation (end without begin, name mismatch)."""


def _round(v):
    return round(float(v), 6) if isinstance(v, float) else v


def _clean_args(args: dict) -> dict:
    return {
        str(k): (
            _round(v) if not isinstance(v, (list, tuple))
            else [_round(x) for x in v]
        )
        for k, v in args.items()
    }


class SpanTracer:
    """Deterministic span/instant/counter recorder on a simulated clock."""

    __slots__ = ("_events", "_stacks", "counter_stride")

    def __init__(self, counter_stride: int = 10) -> None:
        #: finished events: ("X"|"i"|"C", track, name, ts, dur, args)
        self._events: list[tuple] = []
        #: per-track stack of open spans: [(name, ts_begin, args), ...]
        self._stacks: dict[tuple[str, str], list] = {}
        #: sampling stride for per-step counter feeds (the plane emits an
        #: iteration-time counter point every ``counter_stride`` steps)
        self.counter_stride = max(int(counter_stride), 1)

    # ------------------------------------------------------------ record
    def begin(
        self, track: tuple[str, str], name: str, ts: float,
        args: dict | None = None,
    ) -> None:
        """Open a span; spans on one track must nest (stack discipline)."""
        self._stacks.setdefault(track, []).append((name, float(ts), args))

    def end(
        self, track: tuple[str, str], ts: float,
        name: str | None = None, args: dict | None = None,
    ) -> None:
        """Close the innermost open span on ``track``."""
        stack = self._stacks.get(track)
        if not stack:
            raise TraceError(f"end with no open span on track {track!r}")
        open_name, ts0, open_args = stack.pop()
        if name is not None and name != open_name:
            stack.append((open_name, ts0, open_args))
            raise TraceError(
                f"end({name!r}) does not match open span {open_name!r} "
                f"on track {track!r}"
            )
        merged = dict(open_args or {})
        if args:
            merged.update(args)
        self._events.append(
            ("X", track, open_name, ts0, max(float(ts) - ts0, 0.0), merged)
        )

    def span(
        self, track: tuple[str, str], name: str,
        ts_start: float, ts_end: float, args: dict | None = None,
    ) -> None:
        """Record a complete span directly (no stack interaction)."""
        self._events.append((
            "X", track, name, float(ts_start),
            max(float(ts_end) - float(ts_start), 0.0), dict(args or {}),
        ))

    def instant(
        self, track: tuple[str, str], name: str, ts: float,
        args: dict | None = None,
    ) -> None:
        self._events.append(("i", track, name, float(ts), 0.0, dict(args or {})))

    def counter(
        self, track: tuple[str, str], name: str, ts: float, value: float,
    ) -> None:
        self._events.append(
            ("C", track, name, float(ts), 0.0, {name: float(value)})
        )

    # -------------------------------------------------------- inspection
    def open_spans(self) -> dict[tuple[str, str], list[str]]:
        """Names of currently-open spans per track, outermost first."""
        return {
            track: [name for name, _, _ in stack]
            for track, stack in self._stacks.items() if stack
        }

    def close_track(self, track: tuple[str, str], ts: float) -> int:
        """Close every open span on one track (innermost out); returns
        how many were closed."""
        n = 0
        while self._stacks.get(track):
            self.end(track, ts)
            n += 1
        return n

    def close_all(self, ts: float) -> int:
        """Close every open span everywhere — the campaign's horizon
        censoring: a fault span still open when the run ends is truncated
        at the horizon rather than dropped."""
        n = 0
        for track in sorted(self._stacks):
            n += self.close_track(track, ts)
        return n

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> list[tuple]:
        """Finished events in record order: ``(phase, track, name, ts, dur,
        args)``, phase ``"X"`` (span), ``"i"`` (instant) or ``"C"``
        (counter)."""
        return list(self._events)

    # ------------------------------------------------------------ export
    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event dict (Perfetto-loadable).

        pid/tid assignment follows first use, and metadata naming events
        lead the stream — identical recording orders therefore serialize
        byte-identically.
        """
        if any(stack for stack in self._stacks.values()):
            raise TraceError(
                f"open spans at export: {self.open_spans()!r} "
                "(call close_all(horizon) first)"
            )
        pids: dict[str, int] = {}
        tids: dict[tuple[str, str], int] = {}
        for _, track, *_ in self._events:
            proc, thread = track
            if proc not in pids:
                pids[proc] = len(pids) + 1
            if track not in tids:
                tids[track] = (
                    sum(1 for t in tids if t[0] == proc) + 1
                )
        meta: list[dict] = []
        for proc, pid in pids.items():
            meta.append({
                "ph": "M", "pid": pid, "tid": 0, "ts": 0,
                "name": "process_name", "args": {"name": proc},
            })
        for (proc, thread), tid in tids.items():
            meta.append({
                "ph": "M", "pid": pids[proc], "tid": tid, "ts": 0,
                "name": "thread_name", "args": {"name": thread},
            })
        events: list[dict] = []
        for ph, track, name, ts, dur, args in self._events:
            rec: dict = {
                "ph": ph,
                "pid": pids[track[0]],
                "tid": tids[track],
                "ts": int(round(ts * 1e6)),
                "name": name,
            }
            if ph == "X":
                rec["dur"] = int(round(dur * 1e6))
            if ph == "i":
                rec["s"] = "t"  # thread-scoped instant
            if args:
                rec["args"] = _clean_args(args)
            events.append(rec)
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        return json.dumps(self.to_chrome(), indent=1, sort_keys=True) + "\n"

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path
