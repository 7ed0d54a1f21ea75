"""Bounded ring buffers for online detector state.

The detectors track per-worker iteration-time history only to (re)estimate
the jitter scale and to verify candidate change-points over small windows —
both read bounded trailing slices. Storing the full stream (as the seed's
``list.append`` + ``np.asarray`` did) makes every observation O(n) and the
run O(n²); these buffers keep appends O(1) and window reads O(window) while
preserving *absolute* stream indices, so callers keep reasoning in
change-point indices even after old samples are evicted.
"""
from __future__ import annotations

import numpy as np


class RingBuffer:
    """Fixed-capacity float ring buffer addressed by absolute index.

    ``buf.append(x)`` assigns x absolute index ``len(buf) - 1`` (total
    samples ever seen); ``buf.view(lo, hi)`` returns samples ``[lo, hi)`` as
    a contiguous array, clamping ``lo`` to the oldest retained sample.
    """

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._data = np.empty(capacity)
        self._n = 0  # total samples ever appended

    def __len__(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._data.size

    @property
    def start(self) -> int:
        """Absolute index of the oldest retained sample."""
        return max(0, self._n - self._data.size)

    def append(self, x: float) -> None:
        self._data[self._n % self._data.size] = x
        self._n += 1

    def view(self, lo: int, hi: int | None = None) -> np.ndarray:
        """Samples with absolute indices ``[lo, hi)`` (clamped to retained)."""
        cap = self._data.size
        if hi is None or hi > self._n:
            hi = self._n
        lo = max(lo, self.start, 0)
        if hi <= lo:
            return np.empty(0)
        idx = np.arange(lo, hi) % cap
        return self._data[idx]

    def last(self, k: int) -> np.ndarray:
        """The most recent ``k`` samples (fewer if not yet retained)."""
        return self.view(self._n - k, self._n)

    def __getitem__(self, i: int) -> float:
        if not self.start <= i < self._n:
            raise IndexError(f"absolute index {i} not retained")
        return float(self._data[i % self._data.size])


class MatrixRingBuffer:
    """Ring buffer over ``(B,)`` row vectors: the fleet's recent history.

    Rows are ticks (absolute-indexed like :class:`RingBuffer`), columns are
    workers. ``column(w, lo, hi)`` extracts one worker's trailing window for
    escalation without materializing the full fleet history.
    """

    def __init__(self, capacity: int, width: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._data = np.empty((capacity, width))
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._data.shape[0]

    @property
    def width(self) -> int:
        return self._data.shape[1]

    @property
    def start(self) -> int:
        return max(0, self._n - self._data.shape[0])

    def append(self, row: np.ndarray) -> None:
        self._data[self._n % self._data.shape[0]] = row
        self._n += 1

    def add_column(self, fill: float = np.nan) -> int:
        """Append one worker column (dynamic fleet membership).

        Already-retained ticks get ``fill`` for the new worker — its history
        genuinely starts now, and NaN-filled rows poison any window that
        reaches before the join, which is exactly the failure mode we want
        loud. Returns the new column's index.
        """
        cap, w = self._data.shape
        data = np.empty((cap, w + 1))
        data[:, :w] = self._data
        data[:, w] = fill
        self._data = data
        return w

    def remove_column(self, idx: int) -> None:
        """Drop one worker column; columns above ``idx`` shift down by one."""
        self._data = np.delete(self._data, idx, axis=1)

    def rows(self, lo: int, hi: int | None = None) -> np.ndarray:
        """Tick rows ``[lo, hi)`` as a ``(hi - lo, B)`` array (clamped)."""
        cap = self._data.shape[0]
        if hi is None or hi > self._n:
            hi = self._n
        lo = max(lo, self.start, 0)
        if hi <= lo:
            return np.empty((0, self._data.shape[1]))
        idx = np.arange(lo, hi) % cap
        return self._data[idx]

    def column(self, worker: int, lo: int, hi: int | None = None) -> np.ndarray:
        cap = self._data.shape[0]
        if hi is None or hi > self._n:
            hi = self._n
        lo = max(lo, self.start, 0)
        if hi <= lo:
            return np.empty(0)
        idx = np.arange(lo, hi) % cap
        return self._data[idx, worker]
