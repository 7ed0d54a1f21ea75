"""Planner knob auto-tuning against counterfactual value — the twin of
:mod:`repro.whatif.tuning`.

A batch_size_finder-style search (the Lightning binary-search-callback
idiom: probe, measure, narrow) over the
:class:`~repro_torch.core.planner.PlannerKnobs` surface, using the what-if
engine's falcon replay as the measurement: a knob candidate's value is
the fleet time it recovers (``mitigated_s``) on the recorded
campaign(s), averaged across seeds so the tuner optimizes the sweep
mean, not one seed's anecdote.

The search is golden-section over each knob's :data:`KNOB_BOUNDS`
domain (log-spaced where the bound says so), one knob at a time in
coordinate-descent order. The measured objective is steppy — decisions
fire on discrete ticks — so golden-section is used as a robust bracketing
probe rather than a convergence guarantee, and the *default* knob value
is always in the candidate set: the tuner returns the best measured
candidate, which makes the reported gain non-negative by construction.
Whether the gain is real (not one-seed noise) is exactly what averaging
over seeds measures.
"""
from __future__ import annotations

import json
import math
import os

from repro_torch.core.planner import KNOB_BOUNDS, PlannerKnobs
from repro_torch.whatif.replay import WhatIfEngine

#: where tuning artifacts go by default: never into the committed
#: ``results/whatif`` the reference writes
RESULTS_DIR = os.path.join("build", "repro_torch_results", "whatif")

#: golden ratio complement: interval shrink factor per iteration
_INV_PHI = (math.sqrt(5.0) - 1.0) / 2.0


def objective(engines: list[WhatIfEngine], knobs: PlannerKnobs) -> float:
    """Mean fleet %-slowdown-mitigated under a knob bundle across seeds.

    The percentage (not raw seconds) is averaged so every seed's campaign
    weighs equally — the same normalization the sweep tables report.
    """
    vals = []
    for engine in engines:
        t = engine.totals(falcon=engine.with_knobs(knobs))
        if t["mitigated_pct"] is not None:
            vals.append(t["mitigated_pct"])
    return sum(vals) / len(vals) if vals else 0.0


def tune_knob(
    engines: list[WhatIfEngine],
    name: str,
    base: PlannerKnobs,
    iters: int = 8,
) -> tuple[PlannerKnobs, list[dict]]:
    """Golden-section search of one knob, others held at ``base``.

    Returns the best knob bundle found (>= the base by measured
    objective) and the evaluation trace.
    """
    lo, hi, log_scale = KNOB_BOUNDS[name]
    fwd = math.log if log_scale else (lambda x: x)
    inv = math.exp if log_scale else (lambda x: x)
    a, b = fwd(lo), fwd(hi)

    trace: list[dict] = []

    def measure(x: float) -> float:
        knobs = base.replaced(**{name: round(inv(x), 6)})
        val = objective(engines, knobs)
        trace.append({
            "knob": name,
            "value": round(inv(x), 6),
            "objective_pct": round(val, 4),
        })
        return val

    c = b - _INV_PHI * (b - a)
    d = a + _INV_PHI * (b - a)
    fc, fd = measure(c), measure(d)
    for _ in range(max(iters - 2, 0)):
        if fc >= fd:
            b, d, fd = d, c, fc
            c = b - _INV_PHI * (b - a)
            fc = measure(c)
        else:
            a, c, fc = c, d, fd
            d = a + _INV_PHI * (b - a)
            fd = measure(d)

    # The incumbent default only moves on a strict measured improvement:
    # the tuner never regresses, and ties (the objective is steppy) keep
    # the shipped behavior rather than drifting knobs for nothing.
    best_value, best_obj = getattr(base, name), objective(engines, base)
    for t in trace:
        if t["objective_pct"] > best_obj + 1e-9:
            best_value, best_obj = t["value"], t["objective_pct"]
    return base.replaced(**{name: best_value}), trace


def tune(
    engines: list[WhatIfEngine],
    knob_names: tuple[str, ...] = ("breakeven_scale", "prediction_margin"),
    iters: int = 8,
) -> dict:
    """Coordinate-descent auto-tune over the named knobs.

    Returns the tuning artifact: default vs tuned knob values, the
    measured objective for both (mean %-mitigated across the engines'
    seeds), the non-negative gain, and the full evaluation trace.
    """
    for name in knob_names:
        if name not in KNOB_BOUNDS:
            raise KeyError(
                f"unknown knob {name!r}; tunable: {sorted(KNOB_BOUNDS)}"
            )
    base = PlannerKnobs()
    base_obj = objective(engines, base)
    knobs = base
    trace: list[dict] = []
    for name in knob_names:
        knobs, t = tune_knob(engines, name, knobs, iters=iters)
        trace += t
    tuned_obj = objective(engines, knobs)
    if tuned_obj < base_obj:
        # Interaction between sequentially tuned knobs can in principle
        # lose to the defaults; the contract is non-negative gain.
        knobs, tuned_obj = base, base_obj
    seeds = sorted(e.spec.seed for e in engines)
    return {
        "preset": engines[0].spec.preset.name,
        "n_jobs": len(engines[0].spec.jobs),
        "seeds": seeds,
        "knobs_tuned": list(knob_names),
        "default": {
            n: getattr(base, n) for n in sorted(KNOB_BOUNDS)
        },
        "tuned": {
            n: getattr(knobs, n) for n in sorted(KNOB_BOUNDS)
        },
        "objective": "mean slowdown_mitigated_pct over seeds",
        "objective_default_pct": round(base_obj, 4),
        "objective_tuned_pct": round(tuned_obj, 4),
        "gain_pct_points": round(tuned_obj - base_obj, 4),
        "evaluations": trace,
    }


def write_tuning(result: dict, out_dir: str = RESULTS_DIR) -> str:
    """Persist a tuning artifact (deterministic serialization)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir,
        f"{result['preset']}-j{result['n_jobs']}"
        f"-s{len(result['seeds'])}seeds-tuning.json",
    )
    with open(path, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
        f.write("\n")
    return path
