"""Scenario-campaign CLI — the twin of the reference's
``launch/campaign.py``.

    PYTHONPATH=src python -m repro_torch.launch.campaign --preset mixed_fleet \
        --jobs 8 --seed 0 [--ticks N] [--out DIR] [--device cpu] \
        [--obs] [--obs-stride N] [--list-presets] [--quiet]

Builds the campaign (heterogeneous jobs packed on a shared hardware map,
characterization-driven fault schedule), runs it under all four mitigation
modes (healthy / faults / ckpt / falcon), scores the paper metrics from the
typed event log, writes the machine-readable report, and prints a summary.

``--obs`` additionally writes the observability sidecars next to the
report: ``<base>.trace.json`` (the falcon run's simulated-clock span
trace, loadable in Perfetto / ``chrome://tracing``) and
``<base>.metrics.json`` (the metric-catalog snapshot). ``--obs-stride N``
keeps every Nth per-job Observation in the report's event log (sampled
iteration-time lanes; default 0 = none, the byte-stable historical form).
Render dashboards from the report with ``python -m repro_torch.launch.obs``.

``--device`` is where the simulators and the fleet screen run: the card by
default (the CUDA ``bocd_step`` screen), which raises when there is none;
``--device cpu`` runs the plain ``torch`` screen in float64.
``--screening-backend`` / ``--reduction-backend`` override the fleet
screen's and the simulators' compute backends (registry names: screening
``cuda``/``torch``/``batched``/``scalar``, reduction
``cuda``/``torch``/``vectorized``/``reference``); ``--device cpu
--screening-backend batched --reduction-backend vectorized`` is the route
of the committed reports, which the port regenerates byte for byte.

The four modes execute on the shared-prefix
:class:`~repro_torch.scenarios.engine.CampaignEngine` (byte-identical to four
independent runs; the reference's account is docs/scenarios.md);
``--fresh`` forces the independent executions.

Reports and sidecars go to ``build/repro_torch_results/campaigns`` by
default (:data:`repro_torch.scenarios.scoring.RESULTS_DIR`), never into the
committed ``results/campaigns`` the reference writes — the one departure
from the reference's behaviour.
"""
from __future__ import annotations

import argparse

from repro_torch.scenarios import get_preset, list_presets, run_and_score, write_report
from repro_torch.scenarios.scoring import RESULTS_DIR


def _fmt(v) -> str:
    return "-" if v is None else (f"{v:.4g}" if isinstance(v, float) else str(v))


def summarize(report: dict) -> str:
    c = report["campaign"]
    det = report["detection"]
    mit = report["mitigation"]
    lines = [
        f"campaign   {c['preset']} seed={c['seed']} jobs={c['n_jobs']} "
        f"fleet={c['n_nodes']}x{c['gpus_per_node']} "
        f"ticks={c['max_ticks']}@{c['tick_seconds']}s "
        f"injections={c['n_injections']}",
        "",
        f"{'cause':<22}{'precision':>10}{'recall':>8}{'episodes':>9}"
        f"{'diags':>6}{'lat_mean_s':>11}{'lat_p90_s':>10}",
    ]
    rows = {"overall": det["overall"], **det["per_cause"]}
    for name, b in rows.items():
        lines.append(
            f"{name:<22}{_fmt(b['precision']):>10}{_fmt(b['recall']):>8}"
            f"{b['episodes']:>9}{b['diagnoses']:>6}"
            f"{_fmt(b['latency_mean_s']):>11}{_fmt(b['latency_p90_s']):>10}"
        )
    lines += [
        "",
        f"slowdown mitigated   {_fmt(mit['slowdown_mitigated_pct'])} % "
        f"(ckpt-restart baseline {_fmt(mit['slowdown_mitigated_ckpt_pct'])} %, "
        f"paper {mit['paper_slowdown_mitigated_pct']} %)",
        f"avg JCT delay        {_fmt(mit['avg_jct_delay_pct'])} % "
        f"(paper {mit['paper_avg_jct_delay_pct']} %)",
        "",
        f"{'job':<5}{'arch':<18}{'parallel':<14}{'join':>5}{'steps':>7}"
        f"{'jct_falcon':>11}{'delay%':>8}{'mitig%':>8}  mitigations",
    ]
    for j in report["jobs"]:
        lines.append(
            f"{j['job_id']:<5}{j['arch']:<18}{j['parallelism']:<14}"
            f"{j['join_tick']:>5}{j['steps']:>7}"
            f"{j['jct_s']['falcon']:>11}{_fmt(j['jct_delay_pct']):>8}"
            f"{_fmt(j['slowdown_mitigated_pct']):>8}  "
            + (",".join(f"{k}x{v}" for k, v in j["mitigations"].items()) or "-")
        )
    joins = sum(1 for m in report["membership"] if m["action"] == "join")
    leaves = sum(1 for m in report["membership"] if m["action"] == "leave")
    lines.append(
        f"\nmembership churn: {joins} joins, {leaves} leaves; "
        f"events: {report['falcon_event_counts']}"
    )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="mixed_fleet")
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=None,
                    help="override the preset's horizon")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--obs", action="store_true",
                    help="write trace/metrics sidecars next to the report")
    ap.add_argument("--obs-stride", type=int, default=0,
                    help="keep every Nth per-job Observation in the event "
                         "log (0 = none)")
    ap.add_argument("--screening-backend", default=None,
                    help="fleet-screen backend (scalar/batched/torch/cuda/"
                         "auto; default: the control plane's auto selection)")
    ap.add_argument("--reduction-backend", default=None,
                    help="simulator reduction backend (reference/vectorized/"
                         "torch/cuda/auto; default: the simulator's auto "
                         "selection)")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulators and the fleet "
                         "screen (default: the card; 'cpu' on request)")
    ap.add_argument("--fresh", action="store_true",
                    help="bypass the shared-prefix engine and run the four "
                         "modes independently")
    ap.add_argument("--list-presets", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.list_presets:
        for name in list_presets():
            print(f"{name:<28}{get_preset(name).description}")
        return

    spec, runs, report = run_and_score(
        args.preset, n_jobs=args.jobs, seed=args.seed, max_ticks=args.ticks,
        obs=args.obs, observation_stride=args.obs_stride,
        screening_backend=args.screening_backend,
        reduction_backend=args.reduction_backend,
        fresh=args.fresh, device=args.device,
    )
    path = write_report(report, args.out)
    if not args.quiet:
        print(summarize(report))
    print(f"\nreport: {path}")
    if args.obs:
        from repro_torch.obs.recorder import write_sidecars

        for kind, p in sorted(write_sidecars(
            spec, runs, report, out_dir=args.out
        ).items()):
            print(f"{kind}: {p}")


if __name__ == "__main__":
    main()
