"""Per-cause and per-decision JCT attribution via counterfactual replay —
the twin of :mod:`repro.whatif.attribution`.

Leave-one-out (LOO) attribution answers the two questions a campaign
score cannot: *which faults* cost the fleet its slowdown, and *which
planner decisions* earned the mitigation back.

* **Per cause** — remove every episode of one root cause and replay:
  the cause's slowdown contribution is how much the fleet JCT gap
  shrinks, its mitigated contribution how much the recovered time
  shrinks. Both are counterfactual ground truth, not the impact-weighted
  estimate the scorer's ``mitigation.per_cause`` table carries.
* **Per decision** — suppress one recorded decision and replay the
  falcon run: the decision's value is how much the fleet JCT worsens
  without it (negative value = the decision was a net loss; its overhead
  outweighed what it fixed).

LOO contributions need not sum to the total — faults compound and
decisions interact — so every table carries an explicit ``residual_s``
against the report totals; reconciliation means |residual| is small
relative to the total, and the tests pin a tolerance on a two-episode
preset. For small episode sets :func:`shapley` averages marginal
contributions over sampled episode orderings (Shapley values), which
distributes exactly by construction (the sampled estimate carries the
permutation count).

The runs happen wherever the engine's ``device`` puts them. The sampled
permutations come from the host's numpy stream
``np.random.default_rng([seed, 0x5A9])``, the reference's, so the Shapley
artifact is the same bytes in both packages: this is bookkeeping on the
host, not a torch generator.
"""
from __future__ import annotations

import numpy as np

from repro_torch.whatif.replay import Variant, WhatIfEngine, decisions_of


def _round_dict(d: dict, nd: int = 3) -> dict:
    return {
        k: (round(v, nd) if isinstance(v, float) else v)
        for k, v in d.items()
    }


def leave_one_out(
    engine: WhatIfEngine, per_decision: bool = True
) -> dict:
    """Full LOO attribution of one recorded campaign (deterministic)."""
    totals = engine.totals()
    per_cause: dict[str, dict] = {}
    for cause, gids in engine.episodes_by_cause().items():
        variant = Variant(drop_episodes=frozenset(gids))
        faults_wo = engine.run_variant("faults", variant)
        falcon_wo = engine.run_variant("falcon", variant)
        t_wo = engine.totals(faults=faults_wo, falcon=falcon_wo)
        slowdown = totals["gap_s"] - t_wo["gap_s"]
        mitigated = totals["mitigated_s"] - t_wo["mitigated_s"]
        per_cause[cause] = _round_dict({
            "episodes": gids,
            "slowdown_s": slowdown,
            "mitigated_s": mitigated,
            "mitigated_pct": (
                100.0 * mitigated / slowdown if abs(slowdown) > 1e-9 else None
            ),
        })
    cause_slowdown = sum(r["slowdown_s"] for r in per_cause.values())
    cause_mitigated = sum(r["mitigated_s"] for r in per_cause.values())

    decision_rows: list[dict] = []
    decision_total = 0.0
    if per_decision:
        for ref in decisions_of(engine.baseline["falcon"]):
            sup = engine.run_variant(
                "falcon", Variant(suppress=(ref,))
            )
            # Suppressing the decision lowers the recovery by its value
            # (the faults/healthy legs are untouched by a decision edit).
            value = (
                totals["mitigated_s"]
                - engine.totals(falcon=sup)["mitigated_s"]
            )
            decision_total += value
            decision_rows.append(_round_dict({
                "job_id": ref.job_id,
                "strategy": ref.strategy,
                "time_s": round(ref.time, 2),
                "cause": ref.cause,
                "value_s": value,
            }))
        decision_rows.sort(
            key=lambda r: (-r["value_s"], r["time_s"], r["job_id"])
        )

    out = {
        "totals": _round_dict(totals),
        "per_cause": per_cause,
        "per_cause_residual_s": round(
            totals["gap_s"] - cause_slowdown, 3
        ),
        "per_cause_mitigated_residual_s": round(
            totals["mitigated_s"] - cause_mitigated, 3
        ),
    }
    if per_decision:
        out["per_decision"] = decision_rows
        out["per_decision_total_s"] = round(decision_total, 3)
        out["per_decision_residual_s"] = round(
            totals["mitigated_s"] - decision_total, 3
        )
    return out


def shapley(
    engine: WhatIfEngine,
    permutations: int = 16,
    max_episodes: int = 10,
    seed: int = 0,
) -> dict:
    """Sampled-permutation Shapley attribution of the fleet slowdown.

    The value function over an episode subset ``S`` is the fleet JCT gap
    when only ``S`` is injected (everything else dropped); an episode's
    Shapley value is its marginal gap increase averaged over sampled
    orderings. Unlike LOO, Shapley values sum to the total gap exactly
    (per permutation, the telescoping marginals do), so compound-fault
    interaction is *distributed* rather than left in a residual. Costs
    O(permutations x episodes) faults replays — affected-jobs-only and
    cached across permutations sharing prefixes, but still reserved for
    small episode sets (``max_episodes`` guards it).
    """
    touched = sorted(
        {g for p in engine.spec.jobs for g in p.global_ids}
    )
    if len(touched) > max_episodes:
        raise ValueError(
            f"{len(touched)} episodes > max_episodes={max_episodes}: "
            "Shapley sampling is for small episode sets; use leave_one_out"
        )
    all_set = frozenset(touched)

    def gap_of(present: frozenset) -> float:
        run = engine.run_variant(
            "faults", Variant(drop_episodes=all_set - present)
        )
        return engine.totals(faults=run)["gap_s"]

    rng = np.random.default_rng([seed, 0x5A9])
    values = {g: 0.0 for g in touched}
    for _ in range(permutations):
        order = [touched[i] for i in rng.permutation(len(touched))]
        present: frozenset = frozenset()
        prev = 0.0
        for g in order:
            present = present | {g}
            cur = gap_of(present)
            values[g] += cur - prev
            prev = cur
    values = {g: v / permutations for g, v in values.items()}
    total = engine.totals()["gap_s"]
    cause_of = {
        g: c for c, gids in engine.episodes_by_cause().items() for g in gids
    }
    return {
        "permutations": permutations,
        "per_episode": {
            str(g): {
                "cause": cause_of[g],
                "slowdown_s": round(v, 3),
                "share_pct": (
                    round(100.0 * v / total, 2) if total > 1e-9 else None
                ),
            }
            for g, v in sorted(values.items())
        },
        "total_gap_s": round(total, 3),
        "residual_s": round(total - sum(values.values()), 3),
    }
