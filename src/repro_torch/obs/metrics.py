"""Deterministic metrics registry — counters, gauges, histograms.

Prometheus-flavored naming (``name{label="value",...}``) over plain
Python state: metrics are keyed by ``(name, sorted labels)``, histograms
use fixed cumulative buckets, and :meth:`MetricsRegistry.snapshot`
emits everything sorted with fixed float rounding — so a registry fed
from a deterministic event stream serializes byte-identically
(``<name>.metrics.json``, compared byte for byte next to the trace
sidecar).

The metric *catalog* the campaign recorder feeds — detection latency,
diagnosis counts, time-to-mitigate, executor retries/quarantines, wasted
GPU seconds — lives in :mod:`repro_torch.obs.recorder`; this module is the
mechanism and is dependency-free.
"""
from __future__ import annotations

import json

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

#: default histogram bucket upper bounds, in seconds (latency-shaped:
#: sub-tick through multi-hour), cumulative le-style with +Inf implied
DEFAULT_BUCKETS = (
    0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
    1800.0, 3600.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically-increasing total (float increments allowed: some
    totals are seconds, not event counts)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount


class Gauge:
    """A value that is simply *set* (last write wins)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Fixed-bucket cumulative histogram (le semantics, +Inf implied)."""

    __slots__ = ("buckets", "counts", "count", "sum")

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be sorted ascending")
        self.counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> dict[str, int]:
        out: dict[str, int] = {}
        acc = 0
        for le, n in zip(self.buckets, self.counts):
            acc += n
            out[f"{le:g}"] = acc
        out["+Inf"] = acc + self.counts[-1]
        return out


class MetricsRegistry:
    """Get-or-create metric store keyed by (name, labels)."""

    def __init__(self) -> None:
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}
        self._kinds: dict[str, str] = {}  # name -> kind (no cross-kind reuse)

    def _key(self, kind: str, name: str, labels: dict) -> tuple:
        prior = self._kinds.setdefault(name, kind)
        if prior != kind:
            raise ValueError(
                f"metric {name!r} already registered as a {prior}"
            )
        return (name, _label_key(labels))

    def counter(self, name: str, **labels) -> Counter:
        key = self._key("counter", name, labels)
        return self._counters.setdefault(key, Counter())

    def gauge(self, name: str, **labels) -> Gauge:
        key = self._key("gauge", name, labels)
        return self._gauges.setdefault(key, Gauge())

    def histogram(
        self, name: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS,
        **labels,
    ) -> Histogram:
        key = self._key("histogram", name, labels)
        return self._histograms.setdefault(key, Histogram(buckets))

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        """Everything, sorted and rounded — the serialization contract."""

        def rows(store, render):
            return [
                {"name": name, "labels": dict(labels), **render(m)}
                for (name, labels), m in sorted(store.items())
            ]

        return {
            "counters": rows(
                self._counters, lambda m: {"value": round(m.value, 6)}
            ),
            "gauges": rows(
                self._gauges, lambda m: {"value": round(m.value, 6)}
            ),
            "histograms": rows(
                self._histograms,
                lambda m: {
                    "buckets": m.cumulative(),
                    "count": m.count,
                    "sum": round(m.sum, 6),
                },
            ),
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True) + "\n"

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path
