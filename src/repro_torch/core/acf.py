"""ACF-based recurring-period detection (paper §4.2, "Iteration time
analysis") — the twin of :mod:`repro.core.acf`, carried over unchanged.

In iterative training, collective-communication calls repeat with a fixed
period (Fig. 8). Because the framework and model are unknown (R1), the period
is recovered from the raw call sequence with the autocorrelation function:

    ACF(X)_k = Cov(X_t, X_{t+k}) / Var(X_t)

and ``Period = argmin_k (ACF(X)_k > M)`` with threshold M = 0.95.

Two encodings are supported:
  * a symbol sequence of op types (periodicity in *what* is called), and
  * the timestamp deltas (periodicity in *when*), used to derive per-iteration
    times once the symbol period is known.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from repro_torch.core.events import CommEvent

DEFAULT_THRESHOLD = 0.95


def acf(series: np.ndarray, max_lag: int) -> np.ndarray:
    """Return ACF values for lags 1..max_lag (index 0 <-> lag 1).

    Uses the length-normalized (jackknifed) estimator — mean cross-product
    over the n-k overlapping pairs divided by the series variance — so a
    perfectly periodic series scores exactly 1.0 at its period, making the
    paper's M = 0.95 threshold meaningful at any lag (Chatfield, 2013).
    """
    x = np.asarray(series, dtype=np.float64)
    n = x.size
    if n < 2:
        return np.zeros(max_lag)
    mu = x.mean()
    dev = x - mu
    var = float(np.dot(dev, dev)) / n
    if var <= 1e-12:  # constant series: perfectly periodic at every lag
        return np.ones(max_lag)
    out = np.empty(max_lag)
    for k in range(1, max_lag + 1):
        if k >= n:
            out[k - 1] = 0.0
        else:
            out[k - 1] = float(np.dot(dev[:-k], dev[k:])) / (n - k) / var
    return out


def find_period(
    series: np.ndarray,
    max_lag: int | None = None,
    threshold: float = DEFAULT_THRESHOLD,
) -> int | None:
    """First lag k whose ACF exceeds ``threshold`` (paper: argmin_k ACF>M).

    Returns None when no lag qualifies (not enough data / aperiodic).
    """
    x = np.asarray(series, dtype=np.float64)
    if max_lag is None:
        max_lag = max(1, x.size // 3)
    values = acf(x, max_lag)
    hits = np.nonzero(values > threshold)[0]
    if hits.size == 0:
        return None
    return int(hits[0]) + 1


def encode_ops(events: Sequence[CommEvent]) -> np.ndarray:
    """Encode the op-type sequence as floats for ACF computation."""
    symbols: dict[str, int] = {}
    out = np.empty(len(events))
    for i, ev in enumerate(events):
        out[i] = symbols.setdefault(ev.op.value, len(symbols))
    return out


def iteration_times_from_events(
    events: Sequence[CommEvent],
    threshold: float = DEFAULT_THRESHOLD,
) -> tuple[np.ndarray, int | None]:
    """Infer per-iteration times from a raw communication-call log.

    1. Find the recurring period P of the op-type sequence via ACF.
    2. The iteration time is the timestamp difference between a call and the
       same call one period later (paper §4.2).

    Returns (iteration_times, period). Empty array when no period is found.
    """
    if len(events) < 4:
        return np.empty(0), None
    seq = encode_ops(events)
    ts = np.array([ev.timestamp for ev in events])
    # Combine symbol periodicity with timing periodicity: a period must repeat
    # the op pattern; verify candidates on the symbol sequence first.
    period = None
    if np.ptp(seq) > 0:  # symbol sequence is informative
        period = find_period(seq, threshold=threshold)
    if period is None:
        # Fall back to timing deltas: op types may all be identical (e.g.
        # pure-DP training logs only AllReduce), but the *call phases* within
        # an iteration still repeat, so the inter-call gap sequence is
        # periodic with the same period (k gaps per iteration incl. the
        # iteration-boundary gap).
        period = find_period(np.diff(ts), threshold=threshold)
    if period is None:
        return np.empty(0), None
    if period >= len(events):
        return np.empty(0), None
    iter_times = ts[period:] - ts[:-period]
    # One estimate per period (non-overlapping) is the iteration-time series.
    return iter_times[::period], period
