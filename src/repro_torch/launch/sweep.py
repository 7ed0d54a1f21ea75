"""Seed-sweep CLI — paper-style evaluation tables with regression gate;
the twin of the reference's ``launch/sweep.py``.

    PYTHONPATH=src python -m repro_torch.launch.sweep --preset mixed_fleet \
        --jobs 8 --seeds 5 [--workers 4] [--ticks N] [--out DIR] \
        [--device cpu] [--gate results/sweeps/<baseline>.json] \
        [--write-baseline PATH]

Runs a scenario preset over N seeds, aggregates the paper metrics
(precision, recall, detection latency, %-slowdown-mitigated, %-JCT delay)
into mean +/- 95 % CI, writes the table and prints
it. One seed is an anecdote; the sweep is the evaluation number a detector
or planner change must defend.

Seeds are independent campaigns, so ``--workers N`` fans them out over N
processes; the default stays serial (one process, deterministic resource
use) and the table is byte-identical either way — each seed's report is a
pure function of (preset, jobs, seed, ticks), whichever process runs it.

``--gate`` turns the sweep into a CI regression gate: the aggregate is
compared against a committed baseline JSON and the process exits non-zero
when the gated metric (default ``slowdown_mitigated_pct``) drops more than
the baseline's ``max_drop_pct_points`` below its recorded mean.
``--write-baseline`` records the current aggregate as that baseline.

``--device`` is where every seed's simulators and fleet screen run: the
card by default (raising when there is none), ``cpu`` on request. The pool
is a ``spawn`` pool, so each worker starts its own CUDA context (a forked
child cannot use CUDA). Tables go to ``build/repro_torch_results/sweeps``
by default (:data:`RESULTS_DIR`), never into the committed
``results/sweeps`` the reference writes — the one departure from the
reference's behaviour.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

from repro_torch.device import resolve_device
from repro_torch.scenarios import run_and_score

#: default table directory — the port's own, so that a sweep never
#: overwrites the committed reference tables under ``results/``
RESULTS_DIR = os.path.join("build", "repro_torch_results", "sweeps")

#: metrics aggregated across seeds: (name, where to find it in a report)
METRICS = (
    ("precision", ("detection", "overall", "precision")),
    ("recall", ("detection", "overall", "recall")),
    ("latency_mean_s", ("detection", "overall", "latency_mean_s")),
    ("slowdown_mitigated_pct", ("mitigation", "slowdown_mitigated_pct")),
    ("slowdown_mitigated_ckpt_pct",
     ("mitigation", "slowdown_mitigated_ckpt_pct")),
    ("avg_jct_delay_pct", ("mitigation", "avg_jct_delay_pct")),
    # Robustness (hang/executor) metrics: None for presets without hangs,
    # so they aggregate only where they apply.
    ("hang_detection_rate",
     ("robustness", "watchdog", "hang_detection_rate")),
    ("median_time_to_abort_s",
     ("robustness", "watchdog", "median_time_to_abort_s")),
)

#: the gate schema the committed baseline must carry
GATE_SCHEMA_KEYS = ("preset", "jobs", "seeds", "metrics", "gate")


def _dig(report: dict, path: tuple[str, ...]):
    node = report
    for key in path:
        node = node[key]
    return node


def _stats(vals: list[float]) -> dict:
    """Mean and 95 % CI (normal approximation) of one metric's samples."""
    if not vals:
        return {"mean": None, "ci95": None, "n": 0}
    mean = sum(vals) / len(vals)
    if len(vals) > 1:
        var = sum((v - mean) ** 2 for v in vals) / (len(vals) - 1)
        ci = 1.96 * math.sqrt(var / len(vals))
    else:
        ci = 0.0
    return {
        "mean": round(mean, 4),
        "ci95": round(ci, 4),
        "n": len(vals),
        "values": [round(v, 4) for v in vals],
    }


def aggregate(per_seed: list[dict]) -> dict:
    """Mean and 95 % CI per metric across seeds."""
    return {
        name: _stats([
            v for v in (_dig(r, path) for r in per_seed) if v is not None
        ])
        for name, path in METRICS
    }


def _per_cause_of(report: dict) -> dict[str, float | None]:
    """cause -> %-mitigated estimate from one report (may be empty for
    old-format reports that predate the per_cause section)."""
    table = report.get("mitigation", {}).get("per_cause", {})
    return {c: row.get("mitigated_pct") for c, row in table.items()}


def aggregate_per_cause(per_seed: list[dict]) -> dict[str, dict]:
    """Across-seed stats of the per-cause %-mitigated columns.

    Causes vary by seed (a seed may draw no NIC episode), so each cause
    aggregates over the seeds where it occurred — ``n`` says how many.
    Attribution deltas across seeds are only meaningful with this split:
    the scalar mean hides a regression that costs 10 points on
    ``network_congestion`` but is washed out by GPU-heavy seeds.
    """
    causes = sorted({c for r in per_seed for c in _per_cause_of(r)})
    return {
        c: _stats([
            v for v in (_per_cause_of(r).get(c) for r in per_seed)
            if v is not None
        ])
        for c in causes
    }


def _score_one(task: tuple) -> dict:
    """One seed's report (module-level so worker processes can pickle it)."""
    preset, n_jobs, seed, max_ticks, device = task
    _, _, report = run_and_score(
        preset, n_jobs=n_jobs, seed=seed, max_ticks=max_ticks, device=device
    )
    return report


def run_sweep(
    preset: str,
    n_jobs: int | None = None,
    seeds: int = 3,
    max_ticks: int | None = None,
    workers: int = 1,
    device=None,
) -> dict:
    """Run ``seeds`` campaigns (seed 0..N-1) and aggregate the metrics.

    ``workers > 1`` runs the seeds in a process pool; ``map`` keeps seed
    order, and each report is deterministic in its inputs, so the sweep
    dict — and the written table — is byte-identical to the serial run.
    ``device`` (None = the card, raising when there is none) is resolved
    here, before any worker starts, and each worker runs on it.
    """
    device = str(resolve_device(device))
    tasks = [
        (preset, n_jobs, seed, max_ticks, device) for seed in range(seeds)
    ]
    if workers > 1 and seeds > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(workers, seeds)) as pool:
            per_seed = pool.map(_score_one, tasks)
    else:
        per_seed = [_score_one(t) for t in tasks]
    jobs = per_seed[0]["campaign"]["n_jobs"]
    return {
        "preset": preset,
        "jobs": jobs,
        "seeds": seeds,
        "max_ticks": max_ticks,
        "metrics": aggregate(per_seed),
        "per_cause_mitigated_pct": aggregate_per_cause(per_seed),
        "per_seed": [
            {
                "seed": r["campaign"]["seed"],
                **{
                    name: _dig(r, path)
                    for name, path in METRICS
                },
                "per_cause_mitigated_pct": _per_cause_of(r),
            }
            for r in per_seed
        ],
    }


def check_gate(sweep: dict, baseline: dict) -> tuple[bool, str]:
    """Apply a committed baseline's regression gate to a fresh sweep.

    Returns (passed, human-readable verdict). The gate only guards the
    downside: improvements update the baseline via ``--write-baseline``.
    """
    gate = baseline["gate"]
    metric = gate.get("metric", "slowdown_mitigated_pct")
    max_drop = float(gate.get("max_drop_pct_points", 2.0))
    base_mean = baseline["metrics"][metric]["mean"]
    cur_mean = sweep["metrics"][metric]["mean"]
    if base_mean is None or cur_mean is None:
        return False, f"gate metric {metric!r} missing from sweep or baseline"
    drop = base_mean - cur_mean
    verdict = (
        f"{metric}: baseline {base_mean:.2f}, current {cur_mean:.2f} "
        f"(drop {drop:+.2f}, allowed {max_drop:.2f})"
    )
    return drop <= max_drop, verdict


def sweep_table(sweep: dict) -> str:
    lines = [
        f"sweep  {sweep['preset']} jobs={sweep['jobs']} "
        f"seeds={sweep['seeds']}",
        "",
        f"{'metric':<28}{'mean':>10}{'ci95':>9}{'n':>4}",
    ]
    for name, _ in METRICS:
        m = sweep["metrics"][name]
        mean = "-" if m["mean"] is None else f"{m['mean']:.3f}"
        ci = "-" if m["ci95"] is None else f"{m['ci95']:.3f}"
        lines.append(f"{name:<28}{mean:>10}{ci:>9}{m['n']:>4}")
    per_cause = sweep.get("per_cause_mitigated_pct", {})
    for cause, m in sorted(per_cause.items()):
        mean = "-" if m["mean"] is None else f"{m['mean']:.3f}"
        ci = "-" if m["ci95"] is None else f"{m['ci95']:.3f}"
        lines.append(
            f"{'mitigated% ' + cause:<28}{mean:>10}{ci:>9}{m['n']:>4}"
        )
    lines += ["", f"{'seed':<6}" + "".join(
        f"{name[:14]:>16}" for name, _ in METRICS
    )]
    for row in sweep["per_seed"]:
        lines.append(
            f"{row['seed']:<6}" + "".join(
                f"{'-' if row[name] is None else round(row[name], 3):>16}"
                for name, _ in METRICS
            )
        )
    return "\n".join(lines)


def write_sweep(sweep: dict, out_dir: str = RESULTS_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir,
        f"{sweep['preset']}-j{sweep['jobs']}-seeds{sweep['seeds']}.json",
    )
    with open(path, "w") as f:
        json.dump(sweep, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def write_baseline(
    sweep: dict,
    path: str,
    max_drop: float = 2.0,
    metric: str = "slowdown_mitigated_pct",
) -> None:
    baseline = {
        "preset": sweep["preset"],
        "jobs": sweep["jobs"],
        "seeds": sweep["seeds"],
        "metrics": sweep["metrics"],
        "gate": {
            "metric": metric,
            "max_drop_pct_points": max_drop,
        },
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(baseline, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="mixed_fleet")
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--workers", type=int, default=1,
                    help="process fan-out across seeds (default: serial)")
    ap.add_argument("--ticks", type=int, default=None,
                    help="override the preset's horizon")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--gate", default=None,
                    help="baseline JSON to gate against (CI mode)")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="record this sweep as the gate baseline at PATH")
    ap.add_argument("--max-drop", type=float, default=2.0,
                    help="allowed %%-mitigated drop when writing a baseline")
    ap.add_argument("--gate-metric", default="slowdown_mitigated_pct",
                    help="metric a written baseline gates on")
    ap.add_argument("--device", default=None,
                    help="torch device of every seed's simulators and fleet "
                         "screen (default: the card; 'cpu' on request)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    sweep = run_sweep(
        args.preset, n_jobs=args.jobs, seeds=args.seeds,
        max_ticks=args.ticks, workers=args.workers, device=args.device,
    )
    path = write_sweep(sweep, args.out)
    if not args.quiet:
        print(sweep_table(sweep))
    print(f"\nsweep: {path}")

    if args.write_baseline:
        write_baseline(
            sweep, args.write_baseline, args.max_drop,
            metric=args.gate_metric,
        )
        print(f"baseline: {args.write_baseline}")
    if args.gate:
        with open(args.gate) as f:
            baseline = json.load(f)
        missing = [k for k in GATE_SCHEMA_KEYS if k not in baseline]
        if missing:
            print(f"GATE ERROR: baseline missing keys {missing}")
            return 2
        passed, verdict = check_gate(sweep, baseline)
        print(("GATE PASS: " if passed else "GATE FAIL: ") + verdict)
        return 0 if passed else 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
