"""Predictive fault-duration estimation for the ski-rental planner.

The paper's Algorithm 1 escalates when the *accumulated* fail-slow impact
crosses the next strategy's overhead — the classic ski-rental rule, which
implicitly assumes the fault may last forever. The §3 characterization
says otherwise: episode durations are heavy-tailed but *predictable in
distribution* (log-spread from tens of seconds to ~10 hours, with strong
per-cause structure). :class:`DurationModel` turns that into a survival
curve per root cause:

* **Prior** — log-spaced pseudo-observations over the §3 duration range
  (20 s .. 10 h), so a fresh fleet already reasons about remaining
  duration instead of assuming an infinite horizon.
* **Online fit** — every resolved fail-slow feeds its observed duration
  back (:meth:`observe`); durations ended by our *own* checkpoint-restart
  are right-censored (the fault would have lasted longer), handled with a
  weighted Kaplan-Meier estimator so mitigation does not bias the curve
  downward.

:meth:`expected_remaining` is the planner's query: the conditional mean
remaining duration E[T - t | T > t] for a fault of the given cause that
has already survived ``age`` seconds — left-truncated at the age, so the
heavy tail is weighed exactly as much as the evidence supports.
"""
from __future__ import annotations

import math
from bisect import insort
from dataclasses import dataclass, field

from repro_torch.core.events import RootCause

#: §3 duration support: tens of seconds to ~10 hours (Fig. 1 CDF).
PRIOR_RANGE_S: tuple[float, float] = (20.0, 36_000.0)


@dataclass(frozen=True)
class _Sample:
    """One (possibly censored) duration observation."""

    duration: float
    weight: float
    censored: bool  # True: fault outlived the observation (lower bound)

    def __lt__(self, other: "_Sample") -> bool:  # insort ordering
        return self.duration < other.duration


def _log_spaced_prior(
    lo: float, hi: float, points: int, total_weight: float
) -> list[_Sample]:
    w = total_weight / points
    if points == 1:
        return [_Sample(math.sqrt(lo * hi), w, False)]
    ratio = math.log(hi / lo) / (points - 1)
    return [
        _Sample(lo * math.exp(ratio * i), w, False) for i in range(points)
    ]


@dataclass
class DurationModel:
    """Per-cause survival curves, prior-seeded and fit online."""

    prior_range_s: tuple[float, float] = PRIOR_RANGE_S
    prior_points: int = 12
    #: total pseudo-observation weight of the prior (per cause); real
    #: observations carry weight 1 each, so ~this many resolutions make
    #: the data dominate
    prior_weight: float = 6.0

    _samples: dict[RootCause, list[_Sample]] = field(
        init=False, default_factory=dict
    )
    _n_observed: dict[RootCause, int] = field(init=False, default_factory=dict)

    def _cause_samples(self, cause: RootCause) -> list[_Sample]:
        if cause is RootCause.UNKNOWN:
            # Unattributed faults pool the evidence of every cause.
            out: list[_Sample] = []
            for c in RootCause:
                if c is not RootCause.UNKNOWN:
                    out += self._bucket(c)
            return sorted(out)
        return self._bucket(cause)

    def _bucket(self, cause: RootCause) -> list[_Sample]:
        if cause not in self._samples:
            lo, hi = self.prior_range_s
            self._samples[cause] = _log_spaced_prior(
                lo, hi, self.prior_points, self.prior_weight
            )
        return self._samples[cause]

    # ------------------------------------------------------------------
    def observe(
        self, cause: RootCause, duration: float, censored: bool = False
    ) -> None:
        """Record one resolved fail-slow episode's duration.

        ``censored=True`` marks durations ended by our own mitigation
        (checkpoint-restart clears the fault): the true duration is only
        bounded below, and Kaplan-Meier weighs it accordingly.
        """
        if duration <= 0:
            return
        if cause is RootCause.UNKNOWN:
            return  # nothing to attribute the duration to
        insort(self._bucket(cause), _Sample(float(duration), 1.0, censored))
        self._n_observed[cause] = self._n_observed.get(cause, 0) + 1

    def n_observed(self, cause: RootCause) -> int:
        return self._n_observed.get(cause, 0)

    # -- state capture (campaign fork/restore contract) ----------------
    def snapshot(self) -> dict:
        """All fitted state as private copies (samples are frozen
        dataclasses, so copying the lists suffices)."""
        return {
            "samples": {c: list(s) for c, s in self._samples.items()},
            "n_observed": dict(self._n_observed),
        }

    def restore(self, snap: dict) -> None:
        self._samples = {c: list(s) for c, s in snap["samples"].items()}
        self._n_observed = dict(snap["n_observed"])

    # ------------------------------------------------------------------
    def survival(self, cause: RootCause, age: float, horizon: float) -> float:
        """Pr[T > horizon | T > age] under the cause's Kaplan-Meier curve."""
        s, _ = self._km(self._cause_samples(cause), age, horizon)
        return s

    def expected_remaining(self, cause: RootCause, age: float) -> float:
        """E[T - age | T > age]: mean remaining duration at the given age.

        Zero when every observation (prior included) is below ``age`` —
        the fault has outlived all evidence, and the caller's robustness
        cap (escalate anyway once the accumulated impact is a multiple of
        the overhead) takes over.
        """
        _, remaining = self._km(self._cause_samples(cause), age, math.inf)
        return remaining

    @staticmethod
    def _km(
        samples: list[_Sample], age: float, horizon: float
    ) -> tuple[float, float]:
        """Weighted Kaplan-Meier over samples, left-truncated at ``age``.

        Returns ``(S(horizon), integral of S from age)`` — the survival
        probability at the horizon and the restricted mean remaining
        duration. Samples are sorted ascending; only those beyond the age
        enter the risk set (conditioning on T > age). If the last sample
        is censored, the curve's leftover mass is treated as a point mass
        there (restricted mean — the standard KM convention).
        """
        tail = [s for s in samples if s.duration > age]
        if not tail:
            return 0.0, 0.0
        at_risk = sum(s.weight for s in tail)
        surv = 1.0
        remaining = 0.0
        prev = age
        i = 0
        while i < len(tail):
            t = tail[i].duration
            dead = 0.0
            here = 0.0
            while i < len(tail) and tail[i].duration == t:
                here += tail[i].weight
                if not tail[i].censored:
                    dead += tail[i].weight
                i += 1
            step = min(t, horizon) - prev
            if step > 0:
                remaining += surv * step
            if t >= horizon:
                return surv, remaining
            if at_risk > 0 and dead > 0:
                surv *= max(0.0, 1.0 - dead / at_risk)
            at_risk -= here
            prev = t
        return surv, remaining
