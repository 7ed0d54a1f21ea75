"""Shim monitoring layer (paper §4.2, Fig. 7) — the twin of
:mod:`repro.core.monitor`.

The paper's Monitor LD_PRELOAD-hooks NCCL calls and keeps (type, timestamp)
logs in shared memory. Here the shim sits one level up: the framework's
comm wrappers and the trainer's step boundary emit :class:`CommEvent`s into
this Monitor, and the cluster simulator emits the same events for at-scale
studies. Everything downstream (ACF -> BOCD -> profiling -> validation) only
sees the event stream, preserving the framework-agnostic contract (R1).
"""
from __future__ import annotations

import time
from collections import deque
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import acf
from repro_torch.core.events import CommEvent, CommOp


@dataclass
class Monitor:
    """Per-worker communication-event log with iteration-time inference.

    ``clock`` supplies the timestamp for :meth:`record` calls that don't
    pass one explicitly. It defaults to ``time.monotonic`` (real hardware),
    but a driver running on a modeled clock — the trainer's simulated wall
    time, a trace replay cursor — must inject its own so the event log and
    the control-plane events downstream share one timebase.
    """

    max_events: int = 65536
    clock: Callable[[], float] = time.monotonic
    _events: deque[CommEvent] = field(init=False)

    def __post_init__(self) -> None:
        self._events = deque(maxlen=self.max_events)

    # -- logging -------------------------------------------------------
    def record(
        self,
        op: CommOp,
        timestamp: float | None = None,
        group: str = "",
        rank: int = 0,
        duration: float = 0.0,
    ) -> None:
        self._events.append(
            CommEvent(
                op=op,
                timestamp=self.clock() if timestamp is None else timestamp,
                group=group,
                rank=rank,
                duration=duration,
            )
        )

    def extend(self, events: list[CommEvent]) -> None:
        self._events.extend(events)

    def clear(self) -> None:
        self._events.clear()

    @property
    def events(self) -> list[CommEvent]:
        return list(self._events)

    # -- analysis ------------------------------------------------------
    def iteration_times(self, window: int | None = None) -> np.ndarray:
        """Infer the iteration-time series via ACF period detection."""
        evs = self.events
        if window is not None:
            evs = evs[-window:]
        times, _ = acf.iteration_times_from_events(evs)
        return times

    def group_transfer_times(self) -> dict[str, float]:
        """Mean measured transfer duration per communication group.

        Populated during the profiling phase, when durations are attached to
        events (the paper injects CUDA events; the simulator fills them in).
        """
        sums: dict[str, float] = {}
        counts: dict[str, int] = {}
        for ev in self._events:
            if ev.duration > 0.0 and ev.group:
                sums[ev.group] = sums.get(ev.group, 0.0) + ev.duration
                counts[ev.group] = counts.get(ev.group, 0) + 1
        return {g: sums[g] / counts[g] for g in sums}
