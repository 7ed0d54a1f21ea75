"""Ski-rental adaptive multi-level mitigation planner (paper §5.2, Alg. 1).

Start with the cheapest strategy and escalate to the next (more effective,
more costly) one once the *accumulated* fail-slow impact

    slow_impact = slow_iters * (t_slow - t_healthy)

exceeds that strategy's one-off action overhead — the ski-rental break-even
rule. S1 (ignore) has zero overhead and is always applied first; S4
(checkpoint-and-restart) is the last resort.

Predictive break-even (beyond Alg. 1)
-------------------------------------
The classic rule prices every escalation against an *infinite* rental
horizon: it pays overhead B only after suffering B of impact, and it pays
it even when the fault (or the job itself) is about to end. When the
planner is given a :class:`~repro_torch.core.duration.DurationModel` the
break-even uses the predicted benefit instead,

    benefit = min(E[T - age | T > age], work_remaining) * residual_rate

the expected remaining fail-slow impact if nothing more is done, capped by
how much work the job has left and by the observed incident inter-arrival
time (clearing a fault only buys a healthy window until the next one
lands — under a fail-slow storm that window, not the fault's tail, bounds
what any mitigation is worth). Following ski-rental with predictions
(Purohit et al.), the prediction *replaces* the fixed horizon: the rung
fires at ``lambda * B`` when the predicted benefit clearly exceeds the
overhead (``benefit > margin * B`` — act early, the fault will outlast the
investment) and only at ``B / lambda`` otherwise (hold out — the
robustness cap that bounds the damage of a wrong prediction). The margin
matters in practice: under a fail-slow storm the predicted benefit of a
restart hovers right at its overhead, and acting on coin-flip predictions
pays the overhead over and over for healthy windows that never
materialize. With no estimator, the paper's fixed-horizon rule is
reproduced exactly.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from dataclasses import dataclass, field

from repro_torch.core.duration import DurationModel
from repro_torch.core.events import FailSlowEvent, RootCause, Strategy, StrategyKey

#: Which strategies can mitigate which root cause (paper Table 3).
APPLICABLE: dict[RootCause, tuple[Strategy, ...]] = {
    RootCause.CPU_CONTENTION: (
        Strategy.IGNORE,
        Strategy.ADJUST_MICROBATCH,
        Strategy.ADJUST_TOPOLOGY,
        Strategy.CKPT_AND_RESTART,
    ),
    RootCause.GPU_DEGRADATION: (
        Strategy.IGNORE,
        Strategy.ADJUST_MICROBATCH,
        Strategy.ADJUST_TOPOLOGY,
        Strategy.CKPT_AND_RESTART,
    ),
    RootCause.NETWORK_CONGESTION: (
        Strategy.IGNORE,
        Strategy.ADJUST_TOPOLOGY,  # S2 has "No Effect" on slow comm (Table 3)
        Strategy.CKPT_AND_RESTART,
    ),
    RootCause.UNKNOWN: (
        Strategy.IGNORE,
        Strategy.ADJUST_MICROBATCH,
        Strategy.ADJUST_TOPOLOGY,
        Strategy.CKPT_AND_RESTART,
    ),
}

#: Default one-off action overheads in seconds, matching what this repo
#: measures: micro-batch solve is sub-millisecond and applies on the next
#: iteration (Table 6 / benchmarks/microbatch_solver.py — we charge 2 s for
#: the profile + swap); the memory-based topology swap is seconds (Fig. 19 /
#: benchmarks/topology_overhead.py — the paper's worst case is "within one
#: minute"); checkpoint-and-restart is tens of minutes for large models.
DEFAULT_OVERHEADS: dict[Strategy, float] = {
    Strategy.IGNORE: 0.0,
    Strategy.ADJUST_MICROBATCH: 2.0,
    Strategy.ADJUST_TOPOLOGY: 10.0,
    Strategy.CKPT_AND_RESTART: 1800.0,
}


@dataclass(frozen=True)
class PlannerKnobs:
    """The planner's externally settable break-even surface.

    One frozen bundle of every tunable the ski-rental rule exposes, so a
    control plane (or the what-if knob auto-tuner,
    :mod:`repro_torch.whatif.tuning`) can sweep them without touching planner
    internals. Defaults reproduce the shipped behavior exactly.

    * ``prediction_lambda`` / ``prediction_margin`` — the predictive
      two-zone break-even's trust factor and required benefit/overhead
      ratio (see the module docstring).
    * ``breakeven_scale`` — a global multiplier on every rung's escalation
      threshold: < 1 escalates earlier than the classic rule (aggressive),
      > 1 holds out longer (conservative). It scales the *threshold* the
      accumulated impact is compared against, so it composes with both the
      classic and the predictive rules.
    """

    prediction_lambda: float = 0.25
    prediction_margin: float = 1.5
    breakeven_scale: float = 1.0

    def replaced(self, **overrides) -> "PlannerKnobs":
        from dataclasses import replace

        return replace(self, **overrides)


#: knob name -> (lower bound, upper bound, search on log scale) — the
#: domain the auto-tuner may explore (values outside are planner abuse)
KNOB_BOUNDS: dict[str, tuple[float, float, bool]] = {
    "prediction_lambda": (0.05, 1.0, False),
    "prediction_margin": (1.0, 3.0, False),
    "breakeven_scale": (0.25, 4.0, True),
}


def threshold_value(knobs: PlannerKnobs, rec: dict) -> float:
    """Escalation threshold of one recorded break-even consult under
    ``knobs`` — the pure function :meth:`MitigationPlanner._threshold`
    evaluates, split out so a knob bundle can be *re-scored* against a
    recorded decision trace without re-running the campaign.

    ``rec`` carries the knob-independent inputs the consult saw:
    ``overhead``, ``delta``, ``t_now``, ``hang``, and ``window`` — the
    already-resolved min of the estimator's expected remaining duration,
    the job's remaining work and the incident gap (None when the classic
    fixed-horizon rule applies: no estimator, or a zero-overhead rung).
    Every input is independent of the knob values *up to the first
    decision that differs*, which is exactly the prefix a memo needs.
    """
    scale = max(knobs.breakeven_scale, 1e-3)
    overhead = rec["overhead"]
    lam = min(max(knobs.prediction_lambda, 1e-3), 1.0)
    if rec["hang"] and overhead > 0.0:
        rate = min(rec["delta"] / max(rec["t_now"], 1e-12), 1.0)
        window = rec["window"]
        benefit = window if window == float("inf") else window * rate
        return scale * (overhead * lam if benefit > overhead else overhead)
    if rec["window"] is None:
        return scale * overhead
    rate = rec["delta"] / max(rec["t_now"], 1e-12)
    benefit = rec["window"] * rate
    margin = max(knobs.prediction_margin, 1.0)
    return scale * (
        overhead * lam if benefit > overhead * margin else overhead / lam
    )


@dataclass
class MitigationPlanner:
    """Stateful Algorithm 1 for one fail-slow event.

    Drive it with :meth:`update` once per (slow) iteration; it returns the
    strategy to apply *now*, or None. ``event.persist()`` in the paper's
    pseudocode corresponds to the caller ceasing updates once the event is
    resolved (detected by FALCON-DETECT as a relief change-point).
    """

    event: FailSlowEvent
    overheads: dict[StrategyKey, float] = field(
        default_factory=lambda: dict(DEFAULT_OVERHEADS)
    )
    #: explicit candidate ladder (e.g. from a control-plane StrategyRegistry,
    #: which may include custom string-keyed strategies). None reproduces the
    #: paper's Table 3 applicability exactly.
    candidates: Sequence[StrategyKey] | None = None
    #: per-cause fault-duration survival curves; None = the paper's fixed
    #: (infinite) ski-rental horizon
    estimator: DurationModel | None = None
    #: remaining useful work of the job in wall-clock seconds (caps the
    #: benefit any mitigation can still deliver); None = unbounded
    work_remaining: Callable[[], float] | None = None
    #: observed mean wall-clock gap between fresh incidents hitting a job
    #: (the healthy window a successful mitigation can actually buy before
    #: the next fault lands); None = unbounded
    incident_gap: Callable[[], float] | None = None
    #: prediction trust factor in (0, 1]: predicted-profitable escalations
    #: fire at lambda*B, predicted-unprofitable ones only at B/lambda.
    #: 1.0 degenerates to the classic rule even with an estimator.
    prediction_lambda: float = 0.25
    #: required benefit/overhead ratio (>= 1) before the prediction is
    #: trusted enough to escalate early
    prediction_margin: float = 1.5
    #: global multiplier on every rung's escalation threshold (see
    #: :class:`PlannerKnobs.breakeven_scale`); 1.0 = shipped behavior
    breakeven_scale: float = 1.0
    #: optional knob bundle; when given its values override the three
    #: scalar fields above (one injection point for the auto-tuner)
    knobs: PlannerKnobs | None = None
    #: optional shared sink for break-even consult records (see
    #: :func:`threshold_value`): every consult appends its knob-independent
    #: inputs plus the decision taken, so a campaign engine can re-score
    #: alternative knob bundles against the recorded trace without
    #: re-running the timeline
    trace: list | None = None

    _candidates: list[StrategyKey] = field(init=False)
    _id: int = field(init=False, default=0)
    _slow_iters: int = field(init=False, default=0)
    _impact: float = field(init=False, default=0.0)
    #: wall-clock seconds this planner has watched the event degrade
    _age: float = field(init=False, default=0.0)
    applied: list[StrategyKey] = field(init=False, default_factory=list)

    def __post_init__(self) -> None:
        if self.knobs is not None:
            self.prediction_lambda = self.knobs.prediction_lambda
            self.prediction_margin = self.knobs.prediction_margin
            self.breakeven_scale = self.knobs.breakeven_scale
        cands = (
            list(self.candidates)
            if self.candidates is not None
            else list(APPLICABLE[self.event.root_cause])
        )
        cands.sort(key=lambda s: self.overheads[s])  # stable: order tie-breaks
        self._candidates = cands

    @property
    def slow_impact(self) -> float:
        """Accumulated impact: sum over slow iterations of (t - t_healthy)."""
        return self._impact

    def update(
        self, slow_iters: float = 1, current_time: float | None = None
    ) -> StrategyKey | None:
        """Register ``slow_iters`` more degraded iterations; maybe escalate.

        ``slow_iters`` may be fractional: a fleet monitor sampling on a
        fixed cadence observes ``sample_period / iter_time`` iterations per
        sample, and the impact integral must count iterations, not samples,
        for the ski-rental break-even to be in wall-clock units.

        ``current_time`` is the *measured* iteration time now — the paper
        escalates only while "the current strategy proves ineffective", so
        the accumulated impact uses the live residual slowdown, which a
        successful mitigation drives to ~zero. Without it, the detection-time
        (t_slow - t_healthy) delta is charged, reproducing Algorithm 1
        literally.

        Returns the next strategy when the accumulated impact exceeds its
        overhead (Alg. 1 lines 13-15), else None.
        """
        if self.event.resolved or self._id >= len(self._candidates):
            return None
        self._slow_iters += slow_iters
        t_now = current_time if current_time is not None else self.event.t_slow
        self._age += slow_iters * max(t_now, 0.0)
        delta = (
            max(self.event.t_slow - self.event.t_healthy, 0.0)
            if current_time is None
            else max(current_time - self.event.t_healthy, 0.0)
        )
        # Residual within noise of healthy => current strategy is effective.
        if current_time is not None and delta < 0.05 * max(self.event.t_healthy, 1e-12):
            return None
        self._impact += slow_iters * delta
        nxt = self._candidates[self._id]
        fire = self.slow_impact > self._threshold(nxt, delta, t_now)
        if self.trace is not None:
            self.trace[-1]["decision"] = fire
        if fire:
            self._id += 1
            self.applied.append(nxt)
            return nxt
        return None

    def _threshold(self, nxt: StrategyKey, delta: float, t_now: float) -> float:
        """Escalation threshold for the next rung (see module docstring).

        Every branch's result is scaled by ``breakeven_scale``: the knob
        moves the whole break-even surface, not one rule's corner case.

        Hang events (``event.hang``) price an *unbounded* slowdown
        (multiplier → ∞): a hang never relieves itself, so the
        survival-curve query is meaningless (its huge ``_age`` would
        predict ~zero remaining duration, parking the planner in the B/λ
        hold-out forever while the job makes no progress). The benefit of
        acting caps at the job's remaining work, the hold-out zone is
        bypassed, and a non-finite benefit is treated as clearly
        profitable rather than overflowing.

        The consult's knob-independent inputs are resolved here, recorded
        on :attr:`trace` when one is attached, and priced by the pure
        :func:`threshold_value` — the same function a memo uses to
        re-score the trace under different knobs.
        """
        overhead = self.overheads[nxt]
        hang = bool(getattr(self.event, "hang", False))
        window: float | None
        if hang and overhead > 0.0:
            window = float("inf")
            if self.work_remaining is not None:
                window = min(window, max(self.work_remaining(), 0.0))
            if self.incident_gap is not None:
                window = min(window, max(self.incident_gap(), 0.0))
        elif self.estimator is None or overhead <= 0.0:
            window = None
        else:
            # Wall-clock window the fault can keep hurting us: its
            # predicted remaining duration, curtailed by the job's
            # remaining work and by the next incident's arrival.
            window = self.estimator.expected_remaining(
                self.event.root_cause, self._age
            )
            if self.work_remaining is not None:
                window = min(window, max(self.work_remaining(), 0.0))
            if self.incident_gap is not None:
                window = min(window, max(self.incident_gap(), 0.0))
        rec = {
            "overhead": overhead,
            "delta": delta,
            "t_now": t_now,
            "hang": hang,
            "window": window,
        }
        if self.trace is not None:
            rec["impact"] = self._impact
            rec["strategy"] = nxt
            rec["decision"] = False
            self.trace.append(rec)
        knobs = PlannerKnobs(
            prediction_lambda=self.prediction_lambda,
            prediction_margin=self.prediction_margin,
            breakeven_scale=self.breakeven_scale,
        )
        return threshold_value(knobs, rec)

    def exhausted(self) -> bool:
        return self._id >= len(self._candidates)
