"""What-if CLI — counterfactual replay, attribution, knob tuning; the
twin of the reference's ``launch/whatif.py``.

    # attribution of a committed campaign report (the sidecar goes to
    # build/repro_torch_results/campaigns/<report>.attribution.json):
    PYTHONPATH=src python -m repro_torch.launch.whatif \
        --report results/campaigns/mixed_fleet-j8-s0.json --leave-one-out

    # ad-hoc counterfactuals: drop episodes / suppress / force decisions
    ... --preset mixed_fleet --jobs 8 --seed 0 --drop 6 8 \
        --suppress j1:S2P:460 --force j1:CKPT_AND_RESTART:500

    # planner knob auto-tuning (mean objective over N seeds); exits
    # non-zero if the measured gain is negative (the CI gate):
    ... --preset single_gpu_throttle --jobs 1 --tune breakeven_scale \
        --tune-seeds 3

    # "explain this PR": per-cause attribution delta vs a committed
    # baseline report (the CI artifact):
    ... --explain results/campaigns/mixed_fleet-j8-s0.json

Decision specs are ``job:strategy:time`` with the strategy in
:func:`~repro_torch.core.events.strategy_label` form (``ADJUST_MICROBATCH``,
``S2P``, ...). All artifacts serialize deterministically (sorted keys,
fixed rounding, no timestamps) — the attribution sidecar is byte-stable
and diffable in CI.

``--device`` is where every replay runs: the card by default (the CUDA
``bocd_step`` screen), which raises when there is none; ``--device cpu``
runs the plain ``torch`` screen in float64, which regenerates the
committed artifacts byte for byte. Every engine the CLI builds, those of
``--tune``'s other seeds included, takes it.

Artifacts go under ``build/repro_torch_results`` by default, never into
the committed ``results/`` the reference writes: the ``--report``
sidecar to ``build/repro_torch_results/campaigns/<name>.attribution.json``
(:func:`default_sidecar_path`), explain and tuning artifacts to
``build/repro_torch_results/whatif`` (:data:`repro_torch.whatif.tuning.
RESULTS_DIR`). ``--explain`` still reads the committed sidecar next to the
baseline report (:func:`sidecar_path`), as the reference does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.whatif import (
    DecisionRef,
    Variant,
    WhatIfEngine,
    leave_one_out,
    shapley,
    tune,
    write_tuning,
)
from repro_torch.scenarios.scoring import RESULTS_DIR as CAMPAIGNS_DIR
from repro_torch.whatif.tuning import RESULTS_DIR as WHATIF_DIR


def _fmt(v) -> str:
    return "-" if v is None else (f"{v:.3f}" if isinstance(v, float) else str(v))


def parse_decision(spec: str) -> DecisionRef:
    try:
        job, strategy, time_s = spec.split(":")
        return DecisionRef(job_id=job, strategy=strategy, time=float(time_s))
    except ValueError:
        raise SystemExit(
            f"bad decision spec {spec!r}: expected job:strategy:time, "
            "e.g. j1:S2P:460"
        )


def sidecar_path(report_path: str) -> str:
    """The attribution sidecar beside a report (where ``explain`` reads the
    baseline's)."""
    base = report_path[:-5] if report_path.endswith(".json") else report_path
    return base + ".attribution.json"


def default_sidecar_path(report_path: str) -> str:
    """Where ``--report --leave-one-out`` writes the sidecar by default: the
    report's name under :data:`CAMPAIGNS_DIR`, not beside the report."""
    return os.path.join(CAMPAIGNS_DIR, os.path.basename(sidecar_path(report_path)))


def _write_json(payload: dict, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def attribution_table(att: dict) -> str:
    t = att["totals"]
    lines = [
        f"fleet slowdown {t['gap_s']:.1f} s, mitigated {t['mitigated_s']:.1f} s "
        f"({_fmt(t['mitigated_pct'])} %)",
        "",
        f"{'cause':<22}{'slowdown_s':>11}{'mitigated_s':>12}{'mitig%':>8}"
        f"{'episodes':>9}",
    ]
    for cause, row in att["per_cause"].items():
        lines.append(
            f"{cause:<22}{row['slowdown_s']:>11.1f}{row['mitigated_s']:>12.1f}"
            f"{_fmt(row['mitigated_pct']):>8}{len(row['episodes']):>9}"
        )
    lines.append(
        f"{'(interaction residual)':<22}{att['per_cause_residual_s']:>11.1f}"
        f"{att['per_cause_mitigated_residual_s']:>12.1f}"
    )
    if "per_decision" in att:
        lines += [
            "",
            f"{'job':<5}{'strategy':<20}{'t(s)':>8}  {'cause':<22}{'value_s':>9}",
        ]
        for d in att["per_decision"]:
            lines.append(
                f"{d['job_id']:<5}{d['strategy']:<20}{d['time_s']:>8.0f}  "
                f"{d['cause']:<22}{d['value_s']:>9.1f}"
            )
        lines.append(
            f"decision values sum {att['per_decision_total_s']:.1f} s vs "
            f"total mitigated {t['mitigated_s']:.1f} s "
            f"(residual {att['per_decision_residual_s']:.1f} s)"
        )
    return "\n".join(lines)


def explain(engine: WhatIfEngine, att: dict, baseline_path: str) -> dict:
    """Per-cause attribution delta vs a committed baseline report."""
    with open(baseline_path) as f:
        base_report = json.load(f)
    base_side = sidecar_path(baseline_path)
    if os.path.exists(base_side):
        with open(base_side) as f:
            base_causes = json.load(f)["per_cause"]
        source = "attribution sidecar"
    else:
        base_causes = base_report["mitigation"].get("per_cause", {})
        source = "report per-cause estimate"
    rows = {}
    causes = sorted(set(att["per_cause"]) | set(base_causes))
    for cause in causes:
        cur = att["per_cause"].get(cause, {})
        base = base_causes.get(cause, {})
        rows[cause] = {
            "mitigated_s": cur.get("mitigated_s"),
            "baseline_mitigated_s": base.get("mitigated_s"),
            "delta_s": (
                round(cur.get("mitigated_s", 0.0)
                      - base.get("mitigated_s", 0.0), 3)
            ),
            "mitigated_pct": cur.get("mitigated_pct"),
            "baseline_mitigated_pct": base.get("mitigated_pct"),
        }
    base_pct = base_report["mitigation"].get("slowdown_mitigated_pct")
    cur_pct = att["totals"]["mitigated_pct"]
    return {
        "campaign": {
            "preset": engine.spec.preset.name,
            "n_jobs": len(engine.spec.jobs),
            "seed": engine.spec.seed,
        },
        "baseline": {"path": baseline_path, "source": source},
        "slowdown_mitigated_pct": round(cur_pct, 3) if cur_pct is not None else None,
        "baseline_slowdown_mitigated_pct": base_pct,
        "delta_pct_points": (
            round(cur_pct - base_pct, 3)
            if cur_pct is not None and base_pct is not None else None
        ),
        "per_cause": rows,
    }


def explain_table(exp: dict) -> str:
    lines = [
        f"explain vs {exp['baseline']['path']} ({exp['baseline']['source']})",
        f"slowdown mitigated: {_fmt(exp['slowdown_mitigated_pct'])} % now vs "
        f"{_fmt(exp['baseline_slowdown_mitigated_pct'])} % baseline "
        f"({_fmt(exp['delta_pct_points'])} points)",
        "",
        f"{'cause':<22}{'mitig_s':>9}{'base_s':>9}{'delta_s':>9}",
    ]
    for cause, r in exp["per_cause"].items():
        lines.append(
            f"{cause:<22}{_fmt(r['mitigated_s']):>9}"
            f"{_fmt(r['baseline_mitigated_s']):>9}{_fmt(r['delta_s']):>9}"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    src = ap.add_argument_group("campaign identity")
    src.add_argument("--report", default=None,
                     help="committed campaign report to replay (verified)")
    src.add_argument("--preset", default=None)
    src.add_argument("--jobs", type=int, default=None)
    src.add_argument("--seed", type=int, default=0)
    src.add_argument("--ticks", type=int, default=None)

    act = ap.add_argument_group("actions")
    act.add_argument("--leave-one-out", action="store_true",
                     help="per-cause/per-decision LOO attribution + sidecar")
    act.add_argument("--no-decisions", action="store_true",
                     help="skip the per-decision pass (causes only)")
    act.add_argument("--shapley", type=int, default=0, metavar="PERMS",
                     help="add sampled-permutation Shapley episode values")
    act.add_argument("--drop", type=int, nargs="*", default=None,
                     metavar="GID", help="replay without these episode ids")
    act.add_argument("--suppress", nargs="*", default=None,
                     metavar="JOB:STRAT:T", help="replay suppressing these")
    act.add_argument("--force", nargs="*", default=None,
                     metavar="JOB:STRAT:T", help="replay forcing these")
    act.add_argument("--tune", nargs="*", default=None, metavar="KNOB",
                     help="auto-tune planner knobs (default: breakeven_scale "
                          "prediction_margin)")
    act.add_argument("--tune-seeds", type=int, default=3)
    act.add_argument("--tune-iters", type=int, default=8)
    act.add_argument("--explain", default=None, metavar="BASELINE",
                     help="attribution delta vs a committed baseline report")

    ap.add_argument("--out", default=None,
                    help="override the artifact path/dir")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulators and the fleet "
                         "screen (default: the card; 'cpu' on request)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    report = None
    if args.report:
        with open(args.report) as f:
            report = json.load(f)
        engine = WhatIfEngine.from_report(report, device=args.device)
    elif args.preset:
        engine = WhatIfEngine.from_preset(
            args.preset, n_jobs=args.jobs, seed=args.seed,
            max_ticks=args.ticks, device=args.device,
        )
    else:
        ap.error("need --report or --preset")

    did_something = False

    # ---- ad-hoc counterfactual replay
    if args.drop is not None or args.suppress is not None or args.force is not None:
        did_something = True
        variant = Variant(
            drop_episodes=frozenset(args.drop or ()),
            suppress=tuple(parse_decision(s) for s in (args.suppress or ())),
            force=tuple(parse_decision(s) for s in (args.force or ())),
        )
        faults = engine.run_variant("faults", variant)
        falcon = engine.run_variant("falcon", variant)
        base = engine.totals()
        cur = engine.totals(faults=faults, falcon=falcon)
        print(
            f"counterfactual: drop={sorted(variant.drop_episodes)} "
            f"suppress={[d.key() for d in variant.suppress]} "
            f"force={[d.key() for d in variant.force]}"
        )
        print(
            f"  gap       {base['gap_s']:>9.1f} s -> {cur['gap_s']:>9.1f} s"
        )
        print(
            f"  mitigated {base['mitigated_s']:>9.1f} s -> "
            f"{cur['mitigated_s']:>9.1f} s"
        )
        print(
            f"  mitigated% {_fmt(base['mitigated_pct'])} -> "
            f"{_fmt(cur['mitigated_pct'])}"
        )

    # ---- attribution
    att = None
    if args.leave_one_out or args.explain:
        did_something = True
        att = leave_one_out(engine, per_decision=not args.no_decisions)
        if args.shapley > 0:
            att["shapley"] = shapley(engine, permutations=args.shapley)
        att["replay_stats"] = dict(sorted(engine.stats.items()))

    if args.leave_one_out:
        if args.report:
            out_path = args.out or default_sidecar_path(args.report)
        else:
            c = engine.spec
            out_path = args.out or os.path.join(
                CAMPAIGNS_DIR,
                f"{c.preset.name}-j{len(c.jobs)}-s{c.seed}.attribution.json",
            )
        _write_json(att, out_path)
        if not args.quiet:
            print(attribution_table(att))
        print(f"\nattribution: {out_path}")

    # ---- explain-this-PR artifact
    if args.explain:
        exp = explain(engine, att, args.explain)
        c = exp["campaign"]
        out_path = args.out or os.path.join(
            WHATIF_DIR,
            f"explain-{c['preset']}-j{c['n_jobs']}-s{c['seed']}.json",
        )
        _write_json(exp, out_path)
        if not args.quiet:
            print(explain_table(exp))
        print(f"\nexplain artifact: {out_path}")

    # ---- knob auto-tuning
    if args.tune is not None:
        did_something = True
        knob_names = tuple(args.tune) or (
            "breakeven_scale", "prediction_margin"
        )
        preset = engine.spec.preset.name
        n_jobs = len(engine.spec.jobs)
        engines = [engine]
        for s in range(args.tune_seeds):
            if s == engine.spec.seed:
                continue
            engines.append(
                WhatIfEngine.from_preset(
                    preset, n_jobs=n_jobs, seed=s, max_ticks=args.ticks,
                    device=engine.device,
                )
            )
        engines = engines[: max(args.tune_seeds, 1)]
        result = tune(engines, knob_names=knob_names, iters=args.tune_iters)
        path = write_tuning(result) if args.out is None else _write_json(
            result, args.out
        )
        print(
            f"tuned {list(knob_names)} over {len(engines)} seeds: "
            f"{result['objective_default_pct']} % -> "
            f"{result['objective_tuned_pct']} % "
            f"(gain {result['gain_pct_points']:+.3f} points)"
        )
        print(f"tuning artifact: {path}")
        if result["gain_pct_points"] < 0:
            print("TUNE FAIL: negative measured gain")
            return 2

    if not did_something:
        ap.error(
            "nothing to do: pass --leave-one-out, --drop/--suppress/--force, "
            "--tune, or --explain"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
