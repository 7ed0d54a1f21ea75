"""Pluggable mitigation strategies (paper §5, Table 3) + registry.

Each strategy is one class implementing :class:`MitigationStrategy`; the
:class:`StrategyRegistry` is an ordered table the
:class:`~repro_torch.core.planner.MitigationPlanner` escalates through (cheapest
applicable first, the paper's ski-rental rule). The four built-ins port the
ladder that used to be hand-wired in ``FalconTrainer._apply_strategy``:

* :class:`IgnoreStrategy`          — S1, bookkeeping only.
* :class:`MicroBatchStrategy`      — S2, ``core.microbatch.solve_allocation``
  over the profiled per-group speeds.
* :class:`TopologyStrategy`        — S3, targeted congestion swap /
  straggler consolidation / QAP local search from ``core.topology``, with
  the measure-before-commit revert.
* :class:`CkptRestartStrategy`     — S4, restart onto healthy devices.

Two *placement-aware* rungs extend the ladder beyond the paper
(:func:`placement_registry`; Malleus-style group malleability, see
:mod:`repro_torch.core.placement` and docs/mitigation.md):

* :class:`PlacementMicroBatchStrategy` — ``S2P``: when a host-scoped fault
  hits every DP group equally (node-spanning groups leave S2 no skew),
  re-shape the groups so the slow host concentrates in as few of them as
  possible, then re-solve the micro-batch split over the restored skew.
* :class:`PlacementTopologyStrategy`   — ``S3P``: when congestion hits a
  re-shaped layout whose DP rings now cross the congested fabric, restore
  the canonical stage-contiguous placement to internalize ring traffic.

Both measure the modeled iteration time before committing and revert when
the re-shape does not pay (a concentrated layout sends DP rings across
the inter-node fabric — whether that trade wins depends on severity).

A new scenario (e.g. swapping in a hot spare) is one more class registered
with its overhead — no trainer or planner edit; see docs/control_plane.md
for a worked example.
"""
from __future__ import annotations

from collections.abc import Callable, Collection
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.cluster.injector import HANG_KINDS, InjectionKind
from repro_torch.core import microbatch as mb_lib
from repro_torch.core import topology as topo_lib
from repro_torch.core.duration import DurationModel
from repro_torch.core.events import FailSlowEvent, RootCause, Strategy, StrategyKey
from repro_torch.core.placement import PlacementPlanner, slow_devices_for
from repro_torch.core.planner import DEFAULT_OVERHEADS, MitigationPlanner, PlannerKnobs

#: default wall-clock overheads of the placement rungs: a group re-shape
#: exchanges optimizer/parameter shards between the swapped ranks —
#: heavier than an S2 re-split, comparable to an S3 placement swap.
#: ABORT_REFORM (collective abort + group re-form) sits above them: it
#: tears down and rebuilds the communicator state, but stays far below a
#: full checkpoint-restart.
PLACEMENT_OVERHEADS: dict[StrategyKey, float] = {
    "S2P": 8.0, "S3P": 12.0, "ABORT_REFORM": 20.0,
}


@dataclass
class MitigationContext:
    """Everything a strategy may touch when it fires.

    ``now`` is the job clock at dispatch time (before the strategy's own
    overhead is charged). ``injector`` is the job's fail-slow injector when
    one drives the modeled cluster — S4 clears injections that a restart
    onto healthy hardware escapes.
    """

    adapter: object
    event: FailSlowEvent
    now: float = 0.0
    job_id: str = ""
    injector: object | None = None


@dataclass(frozen=True)
class StrategyOutcome:
    """What a dispatch did: ``applied`` + payload for the caller's runtime."""

    applied: bool
    detail: dict = field(default_factory=dict)


@runtime_checkable
class MitigationStrategy(Protocol):
    """One mitigation mechanism, registered under a :data:`StrategyKey`."""

    key: StrategyKey

    def handles(self, event: FailSlowEvent) -> bool:
        """Whether this strategy can act on the event's root cause."""
        ...

    def apply(self, ctx: MitigationContext) -> StrategyOutcome:
        """Perform the mitigation against ``ctx.adapter``."""
        ...

    def relieve(self, ctx: MitigationContext) -> StrategyOutcome | None:
        """Undo skew after the fail-slow resolves (None = nothing to do)."""
        ...


# ------------------------------------------------------------------ S1
@dataclass
class IgnoreStrategy:
    """S1 — tolerate the slowdown; zero overhead, always applicable."""

    key: StrategyKey = Strategy.IGNORE

    def handles(self, event: FailSlowEvent) -> bool:
        return True

    def apply(self, ctx: MitigationContext) -> StrategyOutcome:
        return StrategyOutcome(applied=True)

    def relieve(self, ctx: MitigationContext) -> StrategyOutcome | None:
        return None


# ------------------------------------------------------------------ S2
@dataclass
class MicroBatchStrategy:
    """S2 — redistribute micro-batches by profiled per-group speed."""

    key: StrategyKey = Strategy.ADJUST_MICROBATCH

    def handles(self, event: FailSlowEvent) -> bool:
        if getattr(event, "hang", False):
            return False  # re-splitting batches cannot unstick a hang
        # Table 3: "No Effect" on slow communication.
        return event.root_cause is not RootCause.NETWORK_CONGESTION

    def _solve(self, sim) -> list[int] | None:
        if not hasattr(sim, "per_microbatch_times"):
            return None
        return mb_lib.solve_allocation(
            sim.per_microbatch_times(), sim.job.micro_batches,
            offset=sim.job.pp - 1,
        )

    def apply(self, ctx: MitigationContext) -> StrategyOutcome:
        counts = self._solve(ctx.adapter)
        if counts is None:
            return StrategyOutcome(applied=False)
        ctx.adapter.set_allocation(counts)
        return StrategyOutcome(applied=True, detail={"allocation": counts})

    def relieve(self, ctx: MitigationContext) -> StrategyOutcome | None:
        """Post-relief rebalance: recompute the split from the (now healthy)
        profile so a skewed allocation doesn't outlive the fail-slow it
        compensated for."""
        counts = self._solve(ctx.adapter)
        if counts is None:
            return None
        ctx.adapter.set_allocation(counts)
        return StrategyOutcome(applied=True, detail={"allocation": counts})


# ------------------------------------------------------------------ S3
@dataclass
class TopologyStrategy:
    """S3 — placement adjustment, kept only if modeled time improves.

    A blind consolidation can re-expose a congested link the previous
    targeted swap had evacuated, so mitigation effects are re-measured
    before being committed.
    """

    key: StrategyKey = Strategy.ADJUST_TOPOLOGY
    #: forwarded to the QAP local search (None = library default)
    max_rounds: int | None = None

    def handles(self, event: FailSlowEvent) -> bool:
        # A placement swap routes traffic around a *slow* component; a hung
        # collective blocks every member regardless of where it sits.
        return not getattr(event, "hang", False)

    def apply(self, ctx: MitigationContext) -> StrategyOutcome:
        sim = ctx.adapter
        if not hasattr(sim, "apply_placement"):
            return StrategyOutcome(applied=False)
        before_placement = list(sim.placement)
        before_t = sim.iteration_time()
        self._plan_and_apply(sim, ctx.event)
        if sim.iteration_time() > before_t * 0.999:
            sim.placement = before_placement  # revert: no improvement
            return StrategyOutcome(applied=True, detail={"reverted": True})
        return StrategyOutcome(
            applied=True, detail={"reverted": False, "placement": list(sim.placement)}
        )

    def _plan_and_apply(self, sim, event: FailSlowEvent) -> None:
        job, topo = sim.job, sim.job.topology
        stragglers = [
            int(c.split(":")[1]) for c in event.components if c.startswith("gpu:")
        ]
        slow_links = [
            tuple(int(x) for x in c.split(":")[1].split("-"))
            for c in event.components
            if c.startswith("link:")
        ]
        if stragglers and not slow_links and topo.pp > 1:
            # Straggler consolidation (Fig. 11): pack the positions hosting
            # slow devices into the fewest PP stages.
            pos = [p for p, d in enumerate(sim.placement) if d in set(stragglers)]
            perm = topo_lib.consolidate_stragglers(pos, topo)
            sim.apply_placement(perm)
            return
        m = job.model
        traffic = topo_lib.build_traffic_matrix(
            topo,
            comm_tp=m.comm_tp_bytes(job.tp, job.pp, job.micro_batches),
            comm_dp=m.comm_dp_bytes(job.tp, job.pp),
            comm_pp=m.comm_pp_bytes(job.micro_batches),
        )
        n = job.n_devices
        bw = np.full((n, n), np.inf)
        for i in range(n):
            for j in range(n):
                if i != j:
                    bw[i, j] = sim.state.link_bw(sim.placement[i], sim.placement[j])
        if slow_links:
            # Targeted congestion swap (Fig. 10): FALCON pinpointed the slow
            # physical links; move their endpoints' traffic elsewhere.
            slow_pos = [
                p for p, d in enumerate(sim.placement)
                if any(d in pair for pair in slow_links)
            ]
            perm = topo_lib.plan_targeted_swap(traffic, bw, slow_pos)
        elif self.max_rounds is not None:
            perm = topo_lib.plan_topology_adjustment(
                traffic, bw, max_rounds=self.max_rounds
            )
        else:
            perm = topo_lib.plan_topology_adjustment(traffic, bw)
        sim.apply_placement(perm)

    def relieve(self, ctx: MitigationContext) -> StrategyOutcome | None:
        return None  # placement stays; it is optimal for the healthy state too


# ----------------------------------------------------------------- S2P
def _remap_surface(sim) -> bool:
    return all(
        hasattr(sim, a)
        for a in ("remap_groups", "per_microbatch_times", "set_allocation")
    )


def _solve_alloc(sim) -> list[int]:
    return mb_lib.solve_allocation(
        sim.per_microbatch_times(), sim.job.micro_batches,
        offset=sim.job.pp - 1,
    )


@dataclass
class PlacementMicroBatchStrategy:
    """S2P — re-shape DP groups around a host fault, then re-split batches.

    The remap is committed only if the modeled iteration time beats the
    best S2-alone split on the *current* placement: concentration trades
    intra-node DP rings for inter-node ones, a trade that wins for severe
    faults and loses for weak ones (measured, not assumed).
    """

    key: StrategyKey = "S2P"
    planner: PlacementPlanner = field(default_factory=PlacementPlanner)

    def handles(self, event: FailSlowEvent) -> bool:
        # Compute-side faults with located components: host-scoped (node:)
        # or device-scoped (gpu:) — S2P, like S2, cannot fix slow comm.
        if event.root_cause is RootCause.NETWORK_CONGESTION:
            return False
        if getattr(event, "hang", False):
            return False  # a re-shape cannot unstick a hang either
        return any(
            c.partition(":")[0] in ("node", "gpu") for c in event.components
        )

    #: a concentration must beat the S2-alone split by this factor to be
    #: committed (hysteresis: marginal remaps are not worth carrying into
    #: whatever fault comes next); restoring the canonical layout only
    #: needs to not lose
    commit_factor: float = 0.97

    def apply(self, ctx: MitigationContext) -> StrategyOutcome:
        sim = ctx.adapter
        if not _remap_surface(sim):
            return StrategyOutcome(applied=False)
        node_of = getattr(sim, "node_of_rank", None)
        slow = slow_devices_for(ctx.event, sim.job.n_devices, node_of)
        remap = self.planner.plan(
            tp=sim.job.tp, dp=sim.job.dp, pp=sim.job.pp,
            placement=sim.placement, slow=slow, node_of=node_of,
        )
        # Candidate shapes for the *current* diagnosis: concentrate around
        # it, or fall back to the canonical layout (un-doing a previous
        # concentration whose fault has moved on — compound events replace
        # the diagnosis without a relief, so S2P must re-shape both ways).
        shapes: list[tuple[str, list[int], float]] = []
        if remap is not None:
            shapes.append(
                ("concentrated", list(remap.placement), self.commit_factor)
            )
        canonical = sorted(sim.placement)
        if canonical != list(sim.placement):
            shapes.append(("canonical", canonical, 0.999))
        if not shapes:
            return StrategyOutcome(applied=False, detail={"no_remap": True})
        saved_place = list(sim.placement)
        base_alloc = _solve_alloc(sim)
        sim.set_allocation(base_alloc)
        best_t = sim.iteration_time()
        best: tuple[str, list[int], list[int]] | None = None
        for name, place, factor in shapes:
            sim.remap_groups(place)
            alloc = _solve_alloc(sim)
            sim.set_allocation(alloc)
            t = sim.iteration_time()
            if t < best_t * factor:
                best_t, best = t, (name, place, alloc)
            sim.remap_groups(saved_place)
        if best is None:
            # No shape beats the S2-alone split on the current placement.
            sim.set_allocation(base_alloc)
            return StrategyOutcome(applied=True, detail={"reverted": True})
        name, place, alloc = best
        sim.remap_groups(place)
        sim.set_allocation(alloc)
        detail: dict = {"reverted": False, "shape": name, "allocation": alloc}
        if name == "concentrated" and remap is not None:
            detail["slow_groups"] = list(remap.slow_groups)
        return StrategyOutcome(applied=True, detail=detail)

    def relieve(self, ctx: MitigationContext) -> StrategyOutcome | None:
        """A concentrated layout is *not* optimal for a healthy cluster
        (its DP rings cross nodes): after relief, restore the canonical
        placement when that measures faster."""
        sim = ctx.adapter
        if not _remap_surface(sim):
            return None
        canonical = sorted(sim.placement)
        if canonical == list(sim.placement):
            return None
        saved_place = list(sim.placement)
        sim.set_allocation(_solve_alloc(sim))
        base_t = sim.iteration_time()
        sim.remap_groups(canonical)
        sim.set_allocation(_solve_alloc(sim))
        if sim.iteration_time() >= base_t * 0.999:
            sim.remap_groups(saved_place)
            sim.set_allocation(_solve_alloc(sim))
            return None
        return StrategyOutcome(applied=True, detail={"restored": True})


# ----------------------------------------------------------------- S3P
@dataclass
class PlacementTopologyStrategy:
    """S3P — internalize ring traffic away from congested inter-node fabric.

    The compound-fault counterpart of S2P: a NIC congests *while* a
    re-shaped (concentrated) layout has DP rings crossing that NIC. The
    canonical stage-contiguous placement sends only the light PP
    activations across nodes; restore it when the model says it wins.
    """

    key: StrategyKey = "S3P"

    def handles(self, event: FailSlowEvent) -> bool:
        if getattr(event, "hang", False):
            return False  # hangs take the abort/re-form path, not a re-shape
        if event.root_cause not in (
            RootCause.NETWORK_CONGESTION, RootCause.UNKNOWN
        ):
            return False
        return any(
            c.partition(":")[0] in ("nic", "link") for c in event.components
        )

    def apply(self, ctx: MitigationContext) -> StrategyOutcome:
        sim = ctx.adapter
        if not _remap_surface(sim):
            return StrategyOutcome(applied=False)
        canonical = sorted(sim.placement)
        if canonical == list(sim.placement):
            return StrategyOutcome(applied=False, detail={"no_remap": True})
        saved_place = list(sim.placement)
        # Fair comparison: re-solve the split on the current placement too
        # (its allocation may be stale for the new fault state) before
        # measuring it against the canonical restore.
        base_alloc = _solve_alloc(sim)
        sim.set_allocation(base_alloc)
        base_t = sim.iteration_time()
        sim.remap_groups(canonical)
        sim.set_allocation(_solve_alloc(sim))
        if sim.iteration_time() >= base_t * 0.999:
            sim.remap_groups(saved_place)
            sim.set_allocation(base_alloc)
            return StrategyOutcome(applied=True, detail={"reverted": True})
        return StrategyOutcome(applied=True, detail={"reverted": False})

    def relieve(self, ctx: MitigationContext) -> StrategyOutcome | None:
        return None  # canonical placement is optimal for the healthy state


# ------------------------------------------------------------------ S4
@dataclass
class CkptRestartStrategy:
    """S4 — checkpoint-and-restart onto healthy devices (last resort)."""

    key: StrategyKey = Strategy.CKPT_AND_RESTART

    def handles(self, event: FailSlowEvent) -> bool:
        return True

    def apply(self, ctx: MitigationContext) -> StrategyOutcome:
        sim = ctx.adapter
        if not hasattr(sim, "restart"):
            return StrategyOutcome(applied=False)
        sim.restart()
        if ctx.injector is not None:
            # Restart lands on healthy nodes: clear active injections.
            ctx.injector.injections = [
                i for i in ctx.injector.injections if not i.active(ctx.now)
            ]
        return StrategyOutcome(applied=True, detail={"restarted": True})

    def relieve(self, ctx: MitigationContext) -> StrategyOutcome | None:
        return None


# --------------------------------------------------------- ABORT_REFORM
@dataclass
class AbortReformStrategy:
    """Abort a stalled collective and re-form the communication group.

    The hang-specific rung (CCL-D's abort-and-reform, arXiv 2605.04478): a
    ``COLLECTIVE_HANG`` is *software* state — a collective stuck on a link
    — so aborting the operation and rebuilding the group on the same
    devices clears it. Modeled as dropping the active collective-hang
    injections (the stuck operation is gone) and re-forming the groups to
    the canonical stage-contiguous placement with a fresh micro-batch
    split. A ``GPU_HANG`` is *hardware* — abort cannot revive the device —
    and when the adapter exposes no injector/remap surface there is
    nothing to abort either; both fall back to the S4 restart-onto-healthy
    semantics (the "re-form is impossible" escape hatch).
    """

    key: StrategyKey = "ABORT_REFORM"

    def handles(self, event: FailSlowEvent) -> bool:
        return bool(getattr(event, "hang", False))

    @staticmethod
    def _active_hangs(ctx: MitigationContext) -> list:
        inj = ctx.injector
        if inj is None or not hasattr(inj, "injections"):
            return []
        return [
            i for i in inj.injections
            if getattr(i, "kind", None) in HANG_KINDS and i.active(ctx.now)
        ]

    def apply(self, ctx: MitigationContext) -> StrategyOutcome:
        sim = ctx.adapter
        hangs = self._active_hangs(ctx)
        coll = [
            i for i in hangs if i.kind is InjectionKind.COLLECTIVE_HANG
        ]
        hard = [i for i in hangs if i.kind is InjectionKind.GPU_HANG]
        if not coll or hard or not _remap_surface(sim):
            return self._fallback_s4(ctx)
        inj = ctx.injector
        drop = {id(i) for i in coll}
        # Wholesale reassignment: bumps the injector epoch so schedule
        # cursors re-apply (the same contract S4 relies on).
        inj.injections = [i for i in inj.injections if id(i) not in drop]
        canonical = sorted(sim.placement)
        if canonical != list(sim.placement):
            sim.remap_groups(canonical)
        sim.set_allocation(_solve_alloc(sim))
        return StrategyOutcome(
            applied=True,
            detail={"aborted": len(coll), "reformed": True,
                    "scopes": sorted({i.scope for i in coll if i.scope})},
        )

    def _fallback_s4(self, ctx: MitigationContext) -> StrategyOutcome:
        sim = ctx.adapter
        if not hasattr(sim, "restart"):
            return StrategyOutcome(applied=False, detail={"fallback": "none"})
        sim.restart()
        if ctx.injector is not None and hasattr(ctx.injector, "injections"):
            ctx.injector.injections = [
                i for i in ctx.injector.injections if not i.active(ctx.now)
            ]
        return StrategyOutcome(applied=True, detail={"fallback": "S4"})

    def relieve(self, ctx: MitigationContext) -> StrategyOutcome | None:
        return None


# ------------------------------------------------------------- registry
class StrategyRegistry:
    """Ordered strategy table + planner factory.

    Registration order is the tie-break for equal overheads (the planner's
    sort is stable), so registering S1..S4 in order reproduces the paper's
    ladder exactly; custom strategies slot in wherever their overhead puts
    them.
    """

    def __init__(self) -> None:
        self._table: dict[StrategyKey, MitigationStrategy] = {}
        self._overheads: dict[StrategyKey, float] = {}

    # -- population ----------------------------------------------------
    def register(
        self, strategy: MitigationStrategy, overhead: float | None = None
    ) -> "StrategyRegistry":
        key = strategy.key
        self._table[key] = strategy
        if overhead is not None:
            self._overheads[key] = overhead
        elif key in DEFAULT_OVERHEADS:
            self._overheads.setdefault(key, DEFAULT_OVERHEADS[key])
        elif key in PLACEMENT_OVERHEADS:
            self._overheads.setdefault(key, PLACEMENT_OVERHEADS[key])
        else:
            raise ValueError(f"strategy {key!r} needs an explicit overhead")
        return self

    def __contains__(self, key: StrategyKey) -> bool:
        return key in self._table

    def keys(self) -> list[StrategyKey]:
        return list(self._table)

    def overheads(self, overrides: dict | None = None) -> dict[StrategyKey, float]:
        out = dict(self._overheads)
        if overrides:
            out.update(overrides)
        return out

    # -- planner + dispatch ---------------------------------------------
    def candidates(self, event: FailSlowEvent) -> list[StrategyKey]:
        return [k for k, s in self._table.items() if s.handles(event)]

    def make_planner(
        self,
        event: FailSlowEvent,
        overheads: dict | None = None,
        estimator: DurationModel | None = None,
        work_remaining: Callable[[], float] | None = None,
        incident_gap: Callable[[], float] | None = None,
        exclude: Collection[StrategyKey] | None = None,
        knobs: PlannerKnobs | None = None,
        trace: list | None = None,
    ) -> MitigationPlanner:
        cands = self.candidates(event)
        if exclude:
            cands = [k for k in cands if k not in set(exclude)]
        return MitigationPlanner(
            event,
            self.overheads(overheads),
            candidates=cands,
            estimator=estimator,
            work_remaining=work_remaining,
            incident_gap=incident_gap,
            knobs=knobs,
            trace=trace,
        )

    def dispatch(self, key: StrategyKey, ctx: MitigationContext) -> StrategyOutcome:
        return self._table[key].apply(ctx)

    def relieve(self, ctx: MitigationContext) -> list[tuple[StrategyKey, StrategyOutcome]]:
        out = []
        for key, strat in self._table.items():
            try:
                res = strat.relieve(ctx)
            except Exception as exc:  # one bad relieve must not stop the rest
                res = StrategyOutcome(
                    applied=False,
                    detail={"error": f"{type(exc).__name__}: {exc}"},
                )
            if res is not None:
                out.append((key, res))
        return out


def default_registry(max_rounds: int | None = None) -> StrategyRegistry:
    """The paper's S1-S4 ladder as a registry."""
    reg = StrategyRegistry()
    reg.register(IgnoreStrategy())
    reg.register(MicroBatchStrategy())
    reg.register(TopologyStrategy(max_rounds=max_rounds))
    reg.register(CkptRestartStrategy())
    return reg


def placement_registry(max_rounds: int | None = None) -> StrategyRegistry:
    """The S1-S4 ladder extended with the placement rungs (S2P/S3P) and
    the hang rung (ABORT_REFORM).

    Escalation order follows the overheads: S1, S2, S2P, S3, S3P,
    ABORT_REFORM, S4 — the cheap paper rungs get first claim, the
    re-shapes fire when the skewless/congested cases leave them
    ineffective, and the abort rung (which only handles hang events, for
    which the slowdown rungs all decline) fires before the checkpoint
    sledgehammer.
    """
    reg = StrategyRegistry()
    reg.register(IgnoreStrategy())
    reg.register(MicroBatchStrategy())
    reg.register(PlacementMicroBatchStrategy())
    reg.register(TopologyStrategy(max_rounds=max_rounds))
    reg.register(PlacementTopologyStrategy())
    reg.register(AbortReformStrategy())
    reg.register(CkptRestartStrategy())
    return reg
