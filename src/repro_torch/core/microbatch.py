"""S2 — micro-batch redistribution across DP groups (paper §5.3, Eq. 1).

The paper solves

    min  max_i m_i * t_i    s.t.  m_i in N+,  sum_i m_i = M

with a quadratic-programming relaxation (cvxpy). Because micro-batches are
*unit* jobs on *uniform-speed* machines, the exact integer optimum is reached
greedily: give every group one micro-batch, then repeatedly hand the next
micro-batch to the group whose completion time after receiving it is
smallest. This is list scheduling of identical jobs on uniform machines,
which is optimal for the makespan objective (simple exchange argument; also
property-tested against brute force in tests/test_microbatch.py). It runs in
O(M log D) — microseconds even for 512 DP groups (paper Table 6 reports
~36 s for cvxpy at 512 DP).
"""
from __future__ import annotations

import heapq
from collections.abc import Sequence

import numpy as np


def solve_allocation(
    per_batch_times: Sequence[float], total: int, offset: int = 0
) -> list[int]:
    """Return optimal micro-batch counts m_i for per-micro-batch times t_i.

    ``per_batch_times`` are the profiled per-micro-batch processing times of
    each DP group (FALCON-DETECT's profiling phase, §4.3). ``total`` is M,
    the number of micro-batches in the global batch.

    ``offset`` generalizes Eq. 1 to pipelined groups (beyond-paper): under
    1F1B each DP group's iteration takes (m_i + P - 1) * t_i, so balancing
    m_i*t_i alone leaves the slow group's fill/drain term unpaid. Passing
    offset = P - 1 minimizes max_i (m_i + offset) * t_i instead; offset = 0
    recovers the paper's objective exactly.
    """
    t = [float(x) for x in per_batch_times]
    d = len(t)
    if d == 0:
        raise ValueError("need at least one DP group")
    if any(x <= 0 for x in t):
        raise ValueError("per-micro-batch times must be positive")
    if total < d:
        raise ValueError(f"need at least one micro-batch per group ({total} < {d})")

    counts = [1] * d
    # Min-heap keyed by the completion time if the group got one more batch.
    heap = [((counts[i] + 1 + offset) * t[i], i) for i in range(d)]
    heapq.heapify(heap)
    for _ in range(total - d):
        _, i = heapq.heappop(heap)
        counts[i] += 1
        heapq.heappush(heap, ((counts[i] + 1 + offset) * t[i], i))
    return counts


def makespan(counts: Sequence[int], per_batch_times: Sequence[float]) -> float:
    """Iteration compute time implied by an allocation: max_i m_i * t_i."""
    return max(m * t for m, t in zip(counts, per_batch_times, strict=True))


def gradient_weights(counts: Sequence[int]) -> np.ndarray:
    """Weighted gradient-aggregation weights (paper cites [5]).

    Each DP group's gradient is averaged over its own m_i micro-batches; to
    keep the global update an unbiased mean over all M micro-batches, group i
    gets weight m_i / M.
    """
    m = np.asarray(counts, dtype=np.float64)
    return m / m.sum()


def speedup(
    per_batch_times: Sequence[float], total: int
) -> tuple[list[int], float, float]:
    """Convenience: (allocation, balanced-makespan, even-split-makespan)."""
    d = len(per_batch_times)
    counts = solve_allocation(per_batch_times, total)
    # Without S2, schedulers split evenly: ceil(M/D) micro-batches everywhere,
    # so the slowest group dictates the iteration time.
    even_makespan = max(-(-total // d) * t for t in per_batch_times)
    return counts, makespan(counts, per_batch_times), even_makespan
