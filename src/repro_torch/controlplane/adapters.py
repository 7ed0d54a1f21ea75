"""Cluster adapters — how the control plane talks to a system under test.

:class:`ClusterAdapter` widens the detection-only
:class:`repro_torch.core.detector.ClusterInterface` into the *full* control-plane
contract: observation (iteration times), validation (benchmarks + link
sweeps, with the batched variants the vectorized pinpoint path uses), and
mitigation hooks (allocation / placement / restart).

The plane itself only *requires* the five ClusterInterface methods; it
probes everything beyond them with ``getattr`` and degrades feature by
feature (batched validation falls back to per-pair scalars, strategies
without their hooks report ``applied=False``). Two in-repo sources:

* :class:`repro_torch.cluster.simulator.TrainingSimulator` — the paper's cluster
  performance model; implements the full ClusterAdapter surface.
* :class:`TraceReplayAdapter` (here) — the *minimal* surface: it replays a
  labeled iteration-time trace from :mod:`repro_torch.cluster.traces`, so
  detection runs for real while validation finds no slow component (root
  cause CPU_CONTENTION, the paper's "uniform slowdown, healthy GPUs and
  links" case) and mitigation strategies no-op. It is how recorded
  production traces are driven through the same ControlPlane as live jobs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.cluster.spec import DirtySet
from repro_torch.cluster.traces import LabeledTrace
from repro_torch.core.detector import ClusterInterface


@runtime_checkable
class ClusterAdapter(ClusterInterface, Protocol):
    """The *full* control-plane contract (detection + observation +
    mitigation). Sources that cannot provide a method simply omit it and
    implement only :class:`ClusterInterface` — see the module docstring for
    the degradation rules (``isinstance`` against this protocol therefore
    checks for the complete surface, not the minimum)."""

    # -- observation ---------------------------------------------------
    def iteration_time(self) -> float:
        """Current modeled/measured iteration time of the job."""
        ...

    # -- event-scoped invalidation (per-job dirty cursors) --------------
    def state_cursor(self) -> object:
        """Opaque cursor into the adapter's hardware mutation log. Each
        control-plane reader (job, dashboard, candidate evaluator) holds
        its own cursor, so consuming one reader's dirt never invalidates
        another's view — the contract documented in docs/simulator.md.
        Cursors carry the backing state's identity: one taken before the
        adapter's state was replaced wholesale reads as everything-dirty."""
        ...

    def dirty_since(self, cursor: object) -> DirtySet:
        """Typed set of hardware components mutated since ``cursor``
        (job-local device ranks, link pairs, NIC nodes). Adapters without
        a mutation log simply omit the surface and callers fall back to
        treating every poll as fully dirty."""
        ...

    # -- batched validation (vectorized pinpoint fast path) ------------
    def measure_links(self, pairs: np.ndarray) -> np.ndarray:
        """P2P transfer times for an (k, 2) array of device pairs."""
        ...

    def healthy_link_times(self, pairs: np.ndarray) -> np.ndarray:
        """Expected healthy times for an (k, 2) array of device pairs."""
        ...

    # -- mitigation hooks ----------------------------------------------
    def per_microbatch_times(self) -> list[float]:
        """Per-DP-group per-micro-batch time (S2 solver input)."""
        ...

    def set_allocation(self, counts: list[int]) -> None:
        """Apply a micro-batch allocation (S2)."""
        ...

    def apply_placement(self, perm: list[int]) -> None:
        """Compose a logical->physical permutation onto placement (S3)."""
        ...

    def remap_groups(self, placement: list[int]) -> None:
        """Re-shape communication groups to an explicit device placement
        (S2P/S3P — the placement-aware mitigation rungs)."""
        ...

    def restart(self) -> None:
        """Checkpoint-and-restart onto healthy devices (S4)."""
        ...


@dataclass
class TraceReplayAdapter:
    """Replay a :class:`~repro_torch.cluster.traces.LabeledTrace` as a job.

    ``next_observation()`` advances the replay cursor and returns the next
    iteration time (``None`` at end of trace); the ClusterInterface surface
    reports a healthy, group-less cluster so pinpointing classifies every
    confirmed fail-slow as a host-level (CPU_CONTENTION) incident — a
    recorded scalar trace carries no per-component evidence.
    """

    trace: LabeledTrace
    cursor: int = field(init=False, default=0)

    # -- observation ---------------------------------------------------
    def __len__(self) -> int:
        return int(self.trace.times.size)

    def next_observation(self) -> float | None:
        if self.cursor >= self.trace.times.size:
            return None
        t = float(self.trace.times[self.cursor])
        self.cursor += 1
        return t

    def iteration_time(self) -> float:
        i = min(max(self.cursor - 1, 0), self.trace.times.size - 1)
        return float(self.trace.times[i])

    # -- ClusterInterface (no component evidence in a scalar trace) ----
    def profile_groups(self) -> dict[str, float]:
        return {}

    def group_ranks(self, group: str) -> list[int]:
        return []

    def benchmark_compute(self, ranks: list[int]) -> dict[int, float]:
        return {}

    def measure_link(self, pair: tuple[int, int]) -> float:
        return 0.0

    def healthy_link_time(self, pair: tuple[int, int]) -> float:
        return 0.0
