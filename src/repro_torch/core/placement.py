"""Placement-aware DP-group re-shaping (Malleus-style malleability).

The paper's S2 exploits *skew*: when some DP groups are slower than others,
micro-batches shift toward the fast groups. A host-level fault on a
node-spanning job destroys that skew — with the default stage-major
placement every DP group has exactly one cell on the slow host, so all
groups degrade equally and the S2 solver returns the even split (the
campaign engine's biggest mitigation loss, ROADMAP "node-spanning DP
groups").

:class:`PlacementPlanner` restores the skew by *re-shaping the groups
around the fault* (the malleable re-partitioning of Malleus,
arXiv:2410.13333, applied at the DP-group level): swap ranks across DP
groups so the slow host's members concentrate in as few groups as
possible. The concentrated groups are very slow, the rest fully healthy —
exactly the skew S2/S3 know how to exploit. Whether the trade is worth it
(a concentrated layout sends DP rings across the inter-node fabric) is
decided by the caller measuring the modeled iteration time before
committing, the same measure-before-commit rule as S3.

The planner only *proposes*; :meth:`TrainingSimulator.remap_groups` (or
any :class:`~repro_torch.controlplane.adapters.ClusterAdapter` implementing it)
applies the proposal.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from dataclasses import dataclass

from repro_torch.core.events import FailSlowEvent


@dataclass(frozen=True)
class GroupRemap:
    """A proposed DP-group re-shape.

    ``placement`` is the full logical-position -> physical-device list in
    :class:`~repro_torch.core.topology.HybridTopology` order (stage-major), a
    permutation of the job's current devices. ``slow_groups`` are the DP
    ranks that host every slow device after the re-shape.
    """

    placement: tuple[int, ...]
    slow_groups: tuple[int, ...]
    #: DP groups containing a slow device before / after the re-shape
    groups_hit_before: int
    groups_hit_after: int

    @property
    def concentrates(self) -> bool:
        return self.groups_hit_after < self.groups_hit_before


def slow_devices_for(
    event: FailSlowEvent,
    n_devices: int,
    node_of: Callable[[int], int] | None = None,
) -> set[int]:
    """Physical devices implicated by a diagnosis.

    ``gpu:<rank>`` components name devices directly; ``node:<n>`` (host
    fault) and ``nic:<n>`` (congested port) expand to every device of the
    node when the adapter exposes the node map.
    """
    slow: set[int] = set()
    for comp in event.components:
        kind, _, ident = comp.partition(":")
        try:
            if kind == "gpu":
                slow.add(int(ident))
            elif kind in ("node", "nic") and node_of is not None:
                node = int(ident)
                slow.update(
                    d for d in range(n_devices) if node_of(d) == node
                )
        except ValueError:
            continue
    return {d for d in slow if 0 <= d < n_devices}


@dataclass
class PlacementPlanner:
    """Propose rank swaps that concentrate slow devices into few DP groups."""

    def plan(
        self,
        *,
        tp: int,
        dp: int,
        pp: int,
        placement: Sequence[int],
        slow: set[int],
        node_of: Callable[[int], int] | None = None,
    ) -> GroupRemap | None:
        """Concentrating re-shape of ``placement``, or None if pointless.

        Devices are re-dealt to logical positions group by group (healthy
        devices fill the leading DP ranks, slow devices the trailing ones),
        each class sorted by (node, id) so TP cells and DP-ring segments
        stay node-contiguous — the heavy TP traffic never leaves a node
        that it did not already span. Returns None when the slow set is
        empty, covers every group anyway, or is already maximally
        concentrated (the proposal would be a no-op).
        """
        place = [int(d) for d in placement]
        n = tp * dp * pp
        if len(place) != n:
            raise ValueError(
                f"placement has {len(place)} entries for {n} positions"
            )
        present = set(place)
        slow = {d for d in slow if d in present}
        if not slow:
            return None
        capacity = tp * pp  # devices per DP group
        min_groups = -(-len(slow) // capacity)  # ceil
        hit_before = self._groups_hit(place, slow, tp, dp, pp)
        if min_groups >= dp or len(hit_before) <= min_groups:
            return None

        key = (lambda d: (node_of(d), d)) if node_of is not None else (lambda d: d)
        healthy = sorted((d for d in place if d not in slow), key=key)
        slow_sorted = sorted(slow, key=key)
        order = healthy + slow_sorted
        new_place = list(place)
        i = 0
        for d in range(dp):
            for s in range(pp):
                for k in range(tp):
                    new_place[(s * dp + d) * tp + k] = order[i]
                    i += 1
        hit_after = self._groups_hit(new_place, slow, tp, dp, pp)
        return GroupRemap(
            placement=tuple(new_place),
            slow_groups=tuple(sorted(hit_after)),
            groups_hit_before=len(hit_before),
            groups_hit_after=len(hit_after),
        )

    @staticmethod
    def _groups_hit(
        placement: Sequence[int], slow: set[int], tp: int, dp: int, pp: int
    ) -> set[int]:
        """DP ranks whose group holds at least one slow device."""
        hit: set[int] = set()
        for d in range(dp):
            for s in range(pp):
                base = (s * dp + d) * tp
                if any(placement[base + k] in slow for k in range(tp)):
                    hit.add(d)
                    break
        return hit
