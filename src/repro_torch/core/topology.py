"""S3 — parallelism-topology adjustment (paper §5.3, Figs. 10-11).

Two sub-mechanisms:

1. **Congested-link reassignment** — permute the node->position mapping so a
   congested physical link carries the *lightest*-traffic logical group
   (paper: move it from a heavy DP ring into a light PP edge; Appendix 9.2
   shows Comm_DP = Theta(h^2) >> Comm_PP = Theta(h)). We formulate it as a
   (small) quadratic-assignment instance: logical traffic matrix x physical
   bandwidth matrix, minimized by greedy pairwise-swap local search — the
   paper's own adjustment is a single node swap, so the heuristic subsumes it.

2. **Straggler consolidation** — when several devices are slow, pack them
   into ceil(#stragglers / devices-per-stage) pipeline stages (Fig. 11:
   2 stragglers in one stage cost 8 s; scattered over two stages, 8.5 s),
   preferring *interior* stages since first/last carry embedding/head extras.

Both return **permutations** ``perm`` with the meaning: logical position
``p`` is hosted by physical device ``perm[p]``. The JAX runtime applies them
by rebuilding the Mesh with ``devices[perm]`` and re-sharding the live state
(see train/trainer.py); the simulator applies them to its placement map.
"""
from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HybridTopology:
    """A (TP, DP, PP) hybrid-parallel layout over tp*dp*pp positions.

    Position index = ((pp_stage * dp + dp_rank) * tp + tp_rank) — PP outermost
    so that "a PP stage" is a contiguous block of dp*tp positions, matching
    Megatron rank ordering.
    """

    tp: int
    dp: int
    pp: int

    @property
    def size(self) -> int:
        return self.tp * self.dp * self.pp

    def position(self, stage: int, dp_rank: int, tp_rank: int) -> int:
        return (stage * self.dp + dp_rank) * self.tp + tp_rank

    def stage_of(self, pos: int) -> int:
        return pos // (self.dp * self.tp)


def build_traffic_matrix(
    topo: HybridTopology,
    comm_tp: float,
    comm_dp: float,
    comm_pp: float,
) -> np.ndarray:
    """Per-iteration traffic volume (bytes) between logical positions.

    Volumes follow Appendix 9.2: TP all-reduces within a (stage, dp) cell,
    DP ring all-reduce among replicas of the same (stage, tp) shard, PP
    activations between adjacent stages at the same (dp, tp) coordinate.
    Ring collectives put ~volume/size on each ring edge; we charge each
    adjacent pair accordingly.
    """
    n = topo.size
    t = np.zeros((n, n))

    def add(a: int, b: int, v: float) -> None:
        t[a, b] += v
        t[b, a] += v

    for s in range(topo.pp):
        for d in range(topo.dp):
            # TP ring within the cell.
            if topo.tp > 1:
                per_edge = comm_tp / topo.tp
                for k in range(topo.tp):
                    a = topo.position(s, d, k)
                    b = topo.position(s, d, (k + 1) % topo.tp)
                    add(a, b, per_edge)
        for k in range(topo.tp):
            # DP ring across replicas.
            if topo.dp > 1:
                per_edge = comm_dp / topo.dp
                for d in range(topo.dp):
                    a = topo.position(s, d, k)
                    b = topo.position(s, (d + 1) % topo.dp, k)
                    add(a, b, per_edge)
    for s in range(topo.pp - 1):
        for d in range(topo.dp):
            for k in range(topo.tp):
                add(
                    topo.position(s, d, k),
                    topo.position(s + 1, d, k),
                    comm_pp,
                )
    return t


#: upper-triangle (k=1) index pairs per matrix size — the swap search
#: evaluates thousands of same-size cost calls, so the index build is
#: hoisted out of the hot path (the pairs themselves are size-only).
_TRIU_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _triu(n: int) -> tuple[np.ndarray, np.ndarray]:
    got = _TRIU_CACHE.get(n)
    if got is None:
        got = _TRIU_CACHE[n] = np.triu_indices(n, k=1)
    return got


def assignment_cost(
    perm: Sequence[int],
    traffic: np.ndarray,
    bandwidth: np.ndarray,
) -> tuple[float, float]:
    """(bottleneck, total) communication time of placement ``perm``.

    ``bandwidth[a, b]`` is the physical bandwidth between devices a and b
    (bytes/s); traffic between logical positions i, j flows over the physical
    pair (perm[i], perm[j]).

    Only the strict upper triangle is materialized (both matrices are
    symmetric): each extracted element is the same ``traffic/bandwidth``
    quotient the full-matrix formulation produced, in the same order, so
    the (max, sum) pair is bit-identical to the original full-matrix code.
    """
    p = np.asarray(perm)
    iu0, iu1 = _triu(traffic.shape[0])
    t_vals = traffic[iu0, iu1]
    bw_vals = bandwidth[p[iu0], p[iu1]]
    with np.errstate(divide="ignore", invalid="ignore"):
        vals = np.where(t_vals > 0, t_vals / bw_vals, 0.0)
    return float(vals.max(initial=0.0)), float(vals.sum())


def _greedy_swaps(
    perm: list[int],
    traffic: np.ndarray,
    bandwidth: np.ndarray,
    max_rounds: int,
) -> tuple[list[int], tuple[float, float]]:
    """Best-improving pairwise-swap local search from ``perm``.

    Each round scores *every* candidate swap in one vectorized batch
    instead of n*(n-1)/2 Python-level cost calls. Equivalence with the
    scalar scan is bitwise: candidate rows hold the same quotients the
    scalar ``assignment_cost`` would produce (elementwise ops), the
    per-row total uses the same contiguous 1-D pairwise ``.sum()`` on the
    same values, ``max`` is order-independent, and the winner is the
    first row attaining the minimal (bottleneck, total) pair — exactly
    what the strict-improvement scan over (i, j) in lexicographic order
    kept.
    """
    n = traffic.shape[0]
    perm = list(perm)
    best = assignment_cost(perm, traffic, bandwidth)
    iu0, iu1 = _triu(n)
    m = iu0.size
    if m == 0:
        return perm, best
    t_vals = traffic[iu0, iu1]
    t_pos = t_vals > 0
    for _ in range(max_rounds):
        p = np.asarray(perm)
        # Row r of cands is perm with pair (iu0[r], iu1[r]) swapped — the
        # same (i, j), i < j scan order as the nested loop.
        cands = np.broadcast_to(p, (m, n)).copy()
        rows = np.arange(m)
        cands[rows, iu0] = p[iu1]
        cands[rows, iu1] = p[iu0]
        bw_vals = bandwidth[cands[:, iu0], cands[:, iu1]]
        with np.errstate(divide="ignore", invalid="ignore"):
            times = np.where(t_pos, t_vals / bw_vals, 0.0)
        bott = times.max(axis=1, initial=0.0)
        tot = np.empty(m)
        for r in range(m):
            tot[r] = times[r].sum()
        bb, bs = best
        improved = (bott < bb) | ((bott == bb) & (tot < bs))
        if not improved.any():
            break
        mn_b = bott[improved].min()
        cand = improved & (bott == mn_b)
        mn_s = tot[cand].min()
        r = int(np.flatnonzero(cand & (tot == mn_s))[0])
        i, j = int(iu0[r]), int(iu1[r])
        perm[i], perm[j] = perm[j], perm[i]
        best = (float(mn_b), float(mn_s))
    return perm, best


def plan_topology_adjustment(
    traffic: np.ndarray,
    bandwidth: np.ndarray,
    max_rounds: int = 4,
    n_starts: int = 4,
    seed: int = 0,
) -> list[int]:
    """Multi-start greedy pairwise-swap search minimizing (bottleneck, total).

    Single-swap local search from the identity placement (the running job)
    can plateau: when every DP ring crosses a congested NIC, any one swap
    leaves the congested-crossing count unchanged. Deterministic random
    restarts escape such plateaus; the best local optimum across starts is
    returned (identity is always a candidate, so the result never regresses).
    Complexity O(starts * rounds * n^2) cost evaluations — fine up to a few
    hundred positions; the paper's own mechanism swaps a single node pair.
    """
    n = traffic.shape[0]
    rng = np.random.default_rng(seed)
    starts = [list(range(n))] + [
        list(map(int, rng.permutation(n))) for _ in range(n_starts)
    ]
    best_perm, best_cost = None, (float("inf"), float("inf"))
    for s in starts:
        perm, cost = _greedy_swaps(s, traffic, bandwidth, max_rounds)
        if cost < best_cost:
            best_perm, best_cost = perm, cost
    return best_perm


def plan_targeted_swap(
    traffic: np.ndarray,
    bandwidth: np.ndarray,
    slow_positions: Sequence[int],
    max_rounds: int | None = None,
) -> list[int]:
    """Targeted congestion swap (paper Fig. 10): FALCON-DETECT pinpointed the
    congested links, so instead of a blind QAP search, try swapping only the
    positions *touching* those links against every other position and take
    the best improving swap — the paper's own mechanism is exactly one such
    node swap. O(k*n) cost evaluations per round for k slow endpoints.
    """
    n = traffic.shape[0]
    perm = list(range(n))
    slow = [p for p in slow_positions if 0 <= p < n]
    if not slow:
        return perm
    best = assignment_cost(perm, traffic, bandwidth)
    rounds = max_rounds if max_rounds is not None else len(slow) + 2
    for _ in range(rounds):
        best_swap: tuple[int, int] | None = None
        best_cost = best
        for i in slow:
            pi = perm.index(i)  # position currently hosting endpoint i
            for q in range(n):
                if q == pi:
                    continue
                perm[pi], perm[q] = perm[q], perm[pi]
                c = assignment_cost(perm, traffic, bandwidth)
                perm[pi], perm[q] = perm[q], perm[pi]
                if c < best_cost:
                    best_cost = c
                    best_swap = (pi, q)
        if best_swap is None:
            break
        i, j = best_swap
        perm[i], perm[j] = perm[j], perm[i]
        best = best_cost
    return perm


def consolidate_stragglers(
    stragglers: Sequence[int],
    topo: HybridTopology,
) -> list[int]:
    """Permutation packing straggler devices into the fewest PP stages.

    Returns ``perm`` (logical position -> physical device). Stragglers are
    packed into ceil(k / per_stage) stages; interior stages are preferred
    (paper: first/last stages carry embedding and head extras). Healthy
    devices fill the remaining positions preserving their relative order.
    """
    n = topo.size
    per_stage = topo.dp * topo.tp
    slow = [s for s in stragglers if 0 <= s < n]
    if not slow or topo.pp <= 1:
        return list(range(n))
    k = len(slow)
    n_stages = -(-k // per_stage)
    # Interior-first stage order: 1, 2, ..., pp-2, then 0, pp-1.
    interior = list(range(1, topo.pp - 1))
    order = interior + [0, topo.pp - 1]
    target_stages = sorted(order[:n_stages])

    slow_set = set(slow)
    healthy = [d for d in range(n) if d not in slow_set]
    target_positions: list[int] = []
    for s in target_stages:
        start = s * per_stage
        target_positions.extend(range(start, start + per_stage))
    target_positions = target_positions[: len(slow)]
    target_set = set(target_positions)

    perm: list[int] = [-1] * n
    for pos, dev in zip(target_positions, slow, strict=True):
        perm[pos] = dev
    it = iter(healthy)
    for pos in range(n):
        if pos not in target_set:
            perm[pos] = next(it)
    # Positions in target stages beyond len(slow) still need devices.
    for pos in range(n):
        if perm[pos] == -1:
            perm[pos] = next(it)
    return perm


def straggler_stage_count(perm: Sequence[int], stragglers: Sequence[int], topo: HybridTopology) -> int:
    """Number of PP stages containing at least one straggler under ``perm``."""
    slow = set(stragglers)
    stages = {topo.stage_of(pos) for pos, dev in enumerate(perm) if dev in slow}
    return len(stages)
