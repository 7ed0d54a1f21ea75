"""Counterfactual campaign replay — the twin of :mod:`repro.whatif.replay`
(arXiv 2505.05713).

The campaign runner is deterministic in (preset, jobs, seed), which makes
counterfactuals exact rather than estimated: re-run the *same* campaign
with a fault episode removed, a mitigation decision suppressed, or a
decision forced at a chosen time, and every difference in the outcome is
caused by that change alone. :class:`WhatIfEngine` owns one recorded
campaign (its spec + the four baseline mode runs) and serves such variant
runs, reusing everything the variant cannot change:

* the **spec build** (job packing, fault translation, per-episode impact
  probes) is built once and shared by every variant;
* the **healthy** run is never re-run — no counterfactual changes it;
* **faults**-mode variants re-run only the jobs an edit touches: without
  a control plane jobs never interact (independent rng streams, private
  simulators), so the untouched jobs' baseline outcomes are bit-exact
  for the variant too;
* **falcon**/**ckpt** variants re-run the whole fleet — the plane couples
  jobs through diagnosis dedupe, the shared duration model and the
  incident gap — but identical variants are served from a cache keyed by
  the exact edit.

The replay contract this module relies on (pinned by
tests/test_torch_whatif.py, as tests/test_whatif.py pins the reference's):
dropping every episode reproduces the ``healthy`` run bit-exactly, and
suppressing every decision reproduces the ``faults`` run bit-exactly — see
:func:`repro_torch.scenarios.campaign.run_campaign`.

``device`` is where every run the engine makes builds its simulators and
fleet screen: None is the card (the CUDA ``bocd_step`` screen in float32),
raising a RuntimeError naming ``device="cpu"`` when there is none;
``"cpu"`` gives the plain ``torch`` screen in float64. It reaches the
shared-prefix :class:`~repro_torch.scenarios.engine.CampaignEngine`, every
spec build and every fresh :func:`run_campaign` leg.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.controlplane import MitigationAction
from repro_torch.core.events import Strategy, StrategyKey, strategy_label
from repro_torch.core.planner import PlannerKnobs
from repro_torch.device import resolve_device
from repro_torch.scenarios.campaign import (
    MODES,
    CampaignSpec,
    RunResult,
    build_campaign,
    run_campaign,
)
from repro_torch.scenarios.engine import CampaignEngine
from repro_torch.scenarios.faults import KIND_CAUSE

#: decision times are matched to this resolution (the campaign clock is a
#: tick grid, so exact equality holds; rounding only guards float repr)
TIME_NDIGITS = 6


def _strategy_key(label: str) -> StrategyKey:
    """Inverse of :func:`~repro_torch.core.events.strategy_label`."""
    try:
        return Strategy[label]
    except KeyError:
        return label


@dataclass(frozen=True)
class DecisionRef:
    """Identity of one planner decision inside a recorded campaign.

    ``(job_id, strategy, time)`` is an exact identity: the replay is
    bit-deterministic up to the first edit, so the original run's decision
    at time *t* is the *same* decision in the variant run — there is no
    fuzzy matching to do.
    """

    job_id: str
    strategy: str  # strategy_label() form, e.g. "ADJUST_MICROBATCH", "S2P"
    time: float
    cause: str = ""  # root-cause label of the event it acted on (metadata)

    def key(self) -> tuple[str, str, float]:
        return (self.job_id, self.strategy, round(self.time, TIME_NDIGITS))

    @classmethod
    def from_action(cls, ev: MitigationAction) -> "DecisionRef":
        return cls(
            job_id=ev.job_id,
            strategy=strategy_label(ev.strategy),
            time=float(ev.time),
            cause=ev.event.root_cause.value,
        )


def decisions_of(run: RunResult) -> list[DecisionRef]:
    """The unique planner decisions a recorded run dispatched, in order."""
    seen: dict[tuple, DecisionRef] = {}
    for ev in run.events:
        if isinstance(ev, MitigationAction):
            ref = DecisionRef.from_action(ev)
            seen.setdefault(ref.key(), ref)
    return list(seen.values())


class DecisionScript:
    """A :class:`~repro_torch.controlplane.plane.ControlPlane` decision hook
    that suppresses / forces specific decisions during a replay.

    * ``suppress`` — decisions (by exact :class:`DecisionRef` identity)
      whose dispatch is skipped; the ladder still advances past the rung.
    * ``force`` — decisions dispatched at the first tick at or after
      ``ref.time`` on which the job has an active diagnosis (moving a
      decision to time *t* = suppress the original + force a copy at *t*).
    * ``suppress_all`` — skip every dispatch *and* every relief (the
      faults-mode reproduction; relief must be gated too, because a
      relief rebalance mutates the simulator).
    """

    def __init__(
        self,
        suppress: tuple[DecisionRef, ...] | list[DecisionRef] = (),
        force: tuple[DecisionRef, ...] | list[DecisionRef] = (),
        suppress_all: bool = False,
    ) -> None:
        self.suppress_all = suppress_all
        self._suppress = {d.key() for d in suppress}
        self._force = sorted(force, key=lambda d: (d.time, d.job_id))
        self._forced_done: set[tuple] = set()
        #: suppressions that actually matched a decision during the run
        self.hits: list[tuple[str, str, float]] = []

    def allow(self, job_id: str, strategy: StrategyKey, now: float) -> bool:
        key = (job_id, strategy_label(strategy), round(now, TIME_NDIGITS))
        if self.suppress_all or key in self._suppress:
            self.hits.append(key)
            return False
        return True

    def allow_relief(self, job_id: str, now: float) -> bool:
        return not self.suppress_all

    def forced(self, job_id: str, now: float) -> list[StrategyKey]:
        if self.suppress_all:
            return []
        out: list[StrategyKey] = []
        for ref in self._force:
            k = ref.key()
            if k in self._forced_done or ref.job_id != job_id:
                continue
            if now >= ref.time:
                # The plane only consults us while the job has an active
                # diagnosis, so a returned key IS dispatched.
                self._forced_done.add(k)
                out.append(_strategy_key(ref.strategy))
        return out


@dataclass(frozen=True)
class Variant:
    """One counterfactual edit: what to change relative to the recording."""

    drop_episodes: frozenset[int] = frozenset()
    suppress: tuple[DecisionRef, ...] = ()
    force: tuple[DecisionRef, ...] = ()
    suppress_all: bool = False
    knobs: PlannerKnobs | None = None

    def cache_key(self, mode: str) -> tuple:
        return (
            mode,
            self.drop_episodes,
            tuple(sorted(d.key() for d in self.suppress)),
            tuple(sorted(d.key() for d in self.force)),
            self.suppress_all,
            self.knobs,
        )

    def script(self) -> DecisionScript | None:
        if not (self.suppress or self.force or self.suppress_all):
            return None
        return DecisionScript(
            suppress=self.suppress, force=self.force,
            suppress_all=self.suppress_all,
        )


class WhatIfEngine:
    """Counterfactual replay over one recorded campaign.

    ``device`` (None = the card) is where every run the engine makes
    executes; a caller-owned ``campaign_engine`` brings its own device when
    ``device`` is None.
    """

    def __init__(
        self,
        spec: CampaignSpec,
        baseline: dict[str, RunResult] | None = None,
        campaign_engine: CampaignEngine | None = None,
        device=None,
    ) -> None:
        self.spec = spec
        if device is None and campaign_engine is not None:
            device = campaign_engine.device
        self.device = resolve_device(device)
        #: replay-cost ledger: job-mode runs actually executed vs what the
        #: same variants would have cost fresh (4 modes x all jobs each)
        self.stats = {
            "variants": 0,
            "variant_job_runs": 0,
            "fresh_job_runs_equiv": 0,
            "cache_hits": 0,
        }
        #: shared-prefix executor serving baseline and plane-mode variants
        #: (knob bundles ride its decision-trace memo; decision scripts
        #: replay only the forked leg) — byte-identical to fresh runs
        self._campaign = campaign_engine
        if baseline is None:
            baseline = {mode: self._engine().run(mode) for mode in MODES}
        self.baseline = baseline
        self._cache: dict[tuple, RunResult] = {}

    def _engine(self) -> CampaignEngine:
        if self._campaign is None:
            self._campaign = CampaignEngine(self.spec, device=self.device)
        return self._campaign

    # -- construction ----------------------------------------------------
    @classmethod
    def from_preset(
        cls,
        preset: str,
        n_jobs: int | None = None,
        seed: int = 0,
        max_ticks: int | None = None,
        device=None,
    ) -> "WhatIfEngine":
        device = resolve_device(device)
        spec = build_campaign(
            preset, n_jobs=n_jobs, seed=seed, max_ticks=max_ticks,
            device=device,
        )
        return cls(spec, device=device)

    @classmethod
    def from_report(cls, report: dict, device=None) -> "WhatIfEngine":
        """Rebuild the campaign a committed report records, and verify the
        rebuild reproduces the report's JCTs exactly.

        The report's ``campaign`` section carries the full identity
        (preset, jobs, seed, horizon) and its ``event_log`` the recorded
        decision schedule; determinism means rebuilding from the identity
        *is* loading the recording. The verification guards the one way
        that can silently break — a report committed by a different code
        version — by comparing every job's per-mode JCT (and the decision
        schedule, when an event log is present) against the rebuilt run.
        """
        c = report["campaign"]
        engine = cls.from_preset(
            c["preset"], n_jobs=c["n_jobs"], seed=c["seed"],
            max_ticks=c["max_ticks"], device=device,
        )
        horizon = engine.baseline["falcon"].horizon_s
        for row in report.get("jobs", ()):
            for mode, want in row.get("jct_s", {}).items():
                got = round(
                    engine.baseline[mode].outcomes[row["job_id"]].jct(horizon),
                    2,
                )
                if abs(got - want) > 0.011:
                    raise ValueError(
                        f"report/replay divergence: {row['job_id']} {mode} "
                        f"JCT {want} in report vs {got} replayed — the "
                        "report predates the current campaign code; "
                        "regenerate it via repro_torch.launch.campaign"
                    )
        recorded = [
            (e["job_id"], e["strategy"], round(e["time"], TIME_NDIGITS))
            for e in report.get("event_log", ())
            if e.get("type") == "MitigationAction"
        ]
        if recorded:
            replayed = [
                d.key() for d in decisions_of(engine.baseline["falcon"])
            ]
            if sorted(recorded) != sorted(replayed):
                raise ValueError(
                    "report/replay divergence: the recorded decision "
                    "schedule does not match the rebuilt campaign's"
                )
        return engine

    # -- variant execution -----------------------------------------------
    def affected_jobs(self, drop: frozenset[int]) -> list[str]:
        return [
            p.job_id for p in self.spec.jobs
            if not drop.isdisjoint(p.global_ids)
        ]

    def run_variant(self, mode: str, variant: Variant) -> RunResult:
        """The variant's run for one mode, reusing whatever is exact."""
        self.stats["fresh_job_runs_equiv"] += len(self.spec.jobs)
        if mode == "healthy":
            # No counterfactual edit can change the no-fault floor.
            return self.baseline["healthy"]
        if mode == "faults" and not variant.drop_episodes:
            # Decision edits and knobs are no-ops without a control plane.
            return self.baseline["faults"]
        key = variant.cache_key(mode)
        hit = self._cache.get(key)
        if hit is not None:
            self.stats["cache_hits"] += 1
            return hit
        self.stats["variants"] += 1
        if mode == "faults":
            rerun = self.affected_jobs(variant.drop_episodes)
            self.stats["variant_job_runs"] += len(rerun)
            partial = run_campaign(
                self.spec, "faults",
                drop_episodes=variant.drop_episodes, only_jobs=rerun,
                device=self.device,
            )
            base = self.baseline["faults"]
            merged = RunResult(
                mode="faults",
                outcomes={**base.outcomes, **partial.outcomes},
                events=[],
                ticks_run=base.ticks_run,
                horizon_s=base.horizon_s,
            )
            self._cache[key] = merged
            return merged
        self.stats["variant_job_runs"] += len(self.spec.jobs)
        if variant.drop_episodes:
            # Episode edits change the shared prefix itself — only a
            # fresh run is exact.
            out = run_campaign(
                self.spec, mode,
                drop_episodes=variant.drop_episodes,
                decision_hook=variant.script(),
                planner_knobs=variant.knobs,
                device=self.device,
            )
        else:
            out = self._engine().run(
                mode,
                decision_hook=variant.script(),
                planner_knobs=variant.knobs,
            )
        self._cache[key] = out
        return out

    # -- fleet metrics ----------------------------------------------------
    def totals(
        self,
        faults: RunResult | None = None,
        falcon: RunResult | None = None,
    ) -> dict:
        """Fleet slowdown / mitigated totals, the scorer's clipping rule.

        ``gap_s`` sums each job's (faults − healthy) JCT gap over jobs
        actually slowed; ``mitigated_s`` the (faults − falcon) recovery
        over the same jobs; ``mitigated_pct`` their ratio — exactly the
        report's %-slowdown-mitigated, so attribution deltas reconcile
        against the committed number.
        """
        healthy = self.baseline["healthy"]
        faults = faults if faults is not None else self.baseline["faults"]
        falcon = falcon if falcon is not None else self.baseline["falcon"]
        horizon = healthy.horizon_s
        gap_total = 0.0
        recovered = 0.0
        for p in self.spec.jobs:
            jh = healthy.outcomes[p.job_id].jct(horizon)
            jf = faults.outcomes[p.job_id].jct(horizon)
            jm = falcon.outcomes[p.job_id].jct(horizon)
            gap = jf - jh
            if gap > 1e-9:
                gap_total += gap
                recovered += jf - jm
        return {
            "gap_s": gap_total,
            "mitigated_s": recovered,
            "mitigated_pct": (
                100.0 * recovered / gap_total if gap_total > 1e-9 else None
            ),
        }

    def episodes_by_cause(self) -> dict[str, list[int]]:
        """Global episode ids grouped by root cause, visible episodes only
        (an episode no job's slice feels attributes nothing)."""
        touched = {g for p in self.spec.jobs for g in p.global_ids}
        out: dict[str, list[int]] = {}
        for gi, inj in enumerate(self.spec.schedule):
            if gi in touched:
                out.setdefault(KIND_CAUSE[inj.kind].value, []).append(gi)
        return {k: sorted(v) for k, v in sorted(out.items())}

    def with_knobs(self, knobs: PlannerKnobs) -> RunResult:
        """The falcon run under a knob bundle (the auto-tuner's probe)."""
        return self.run_variant("falcon", Variant(knobs=knobs))
