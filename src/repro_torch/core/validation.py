"""O(1) validation of ring/tree communicators (paper §4.3, Fig. 9).

Collective communicators are decomposed into *non-overlapping* P2P
send-receive passes so each pass runs fully in parallel: link validation
takes a constant number of passes regardless of group size —

  * even ring: 2 passes,
  * odd ring:  3 passes,
  * binary tree: 4 passes (left/right children x even/odd levels).

Every pass is a list of disjoint (src, dst) pairs. Since all transfers move
identical payloads, a slow link simply measures a longer time than the
pass median and is flagged.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence

Pair = tuple[int, int]


def ring_links(n: int) -> list[Pair]:
    """All links of an n-rank ring: (i, i+1 mod n)."""
    if n < 2:
        return []
    if n == 2:
        return [(0, 1)]
    return [(i, (i + 1) % n) for i in range(n)]


def ring_passes(n: int) -> list[list[Pair]]:
    """Decompose an n-ring into 2 (even n) or 3 (odd n) disjoint passes."""
    if n < 2:
        return []
    if n == 2:
        return [[(0, 1)]]
    even_pass = [(i, i + 1) for i in range(0, n - 1, 2)]
    odd_pass = [(i, i + 1) for i in range(1, n - 1, 2)]
    if n % 2 == 0:
        odd_pass.append((n - 1, 0))
        return [even_pass, odd_pass]
    return [even_pass, odd_pass, [(n - 1, 0)]]


def tree_links(parents: Sequence[int | None]) -> list[Pair]:
    """All (child, parent) links of a tree given a parent array."""
    return [(c, p) for c, p in enumerate(parents) if p is not None]


def binary_tree_parents(n: int) -> list[int | None]:
    """Parent array of the implicit complete binary tree on ranks 0..n-1."""
    return [None if i == 0 else (i - 1) // 2 for i in range(n)]


def tree_passes(parents: Sequence[int | None]) -> list[list[Pair]]:
    """Decompose a binary tree into exactly 4 disjoint passes (Fig. 9 right).

    Pass 1: left children at even depths -> parent.
    Pass 2: right children at even depths -> parent.
    Pass 3: left children at odd depths -> parent.
    Pass 4: right children at odd depths -> parent.

    Within a pass, every parent receives from at most one child and acts as
    receiver only (its own uplink is exercised in a pass of opposite depth
    parity), so pairs are node-disjoint.
    """
    n = len(parents)
    depth = [0] * n
    for i in range(n):
        p = parents[i]
        if p is not None:
            depth[i] = depth[p] + 1
    is_left: dict[int, bool] = {}
    seen_children: dict[int, int] = {}
    for i in range(n):
        p = parents[i]
        if p is None:
            continue
        seen_children[p] = seen_children.get(p, 0) + 1
        is_left[i] = seen_children[p] == 1
    passes: list[list[Pair]] = [[], [], [], []]
    for i in range(n):
        p = parents[i]
        if p is None:
            continue
        # Child depth parity: children at odd depth have parents at even
        # levels ("even-level children" in the paper's phrasing counts the
        # parent level); group by parent-level parity.
        parent_even = depth[p] % 2 == 0
        idx = (0 if is_left[i] else 1) if parent_even else (2 if is_left[i] else 3)
        passes[idx].append((i, p))
    return [p for p in passes]


def validate_links(
    passes: Sequence[Sequence[Pair]],
    measure: Callable[[Pair], float],
    slow_factor: float = 1.5,
    reference: Callable[[Pair], float] | None = None,
) -> tuple[list[Pair], dict[Pair, float]]:
    """Execute the pass schedule and flag slow links.

    ``measure`` returns the transfer time for one P2P pair (in the real
    system this is the benchmark executor; in tests/benchmarks it queries the
    cluster simulator). When ``reference`` supplies the link's *expected*
    healthy time (links have heterogeneous classes: NVLink vs PCIe vs RDMA —
    the paper's executor knows the fabric), a link is slow when it exceeds
    ``slow_factor`` x its own reference. Without a reference, payloads are
    identical so the median across all links is the yardstick.
    """
    times: dict[Pair, float] = {}
    for p in passes:
        for pair in p:
            times[pair] = measure(pair)
    if not times:
        return [], {}
    if reference is not None:
        slow = [
            pair for pair, t in times.items()
            if t > slow_factor * max(reference(pair), 1e-12)
        ]
        return slow, times
    vals = sorted(times.values())
    median = vals[len(vals) // 2]
    slow = [pair for pair, t in times.items() if t > slow_factor * median]
    return slow, times


def check_disjoint(passes: Sequence[Sequence[Pair]]) -> bool:
    """True iff every pass uses each rank at most once (fully parallel)."""
    for p in passes:
        used: set[int] = set()
        for a, b in p:
            if a in used or b in used:
                return False
            used.update((a, b))
    return True
