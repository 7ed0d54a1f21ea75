"""Paper-metric scoring of a campaign from the typed event log.

Three metric families, matching the paper's evaluation tables:

* **Detection** (Tables 4-5): per-cause precision, recall and detection
  latency of the control plane's onset :class:`Diagnosis` events against
  the ground-truth injection schedule. Ground truth is *observability-
  aware*: an episode counts toward recall only if its modeled iteration-
  time impact on that job clears the detectability threshold (the paper's
  human labels likewise only mark fail-slows that are visible in the
  trace), it starts after the job's detector warmup, and enough of it
  overlaps the job's lifetime to be seen. Overlapping episodes on one job
  are merged — the detector state-machine reports compound fail-slows as
  one incident chain, so they are scored as one.
* **Mitigation** (Fig. 20 / Table 7): per-job and fleet %-slowdown
  mitigated, computed from the JCT gap between the ``faults`` (no
  mitigation) ceiling and the ``healthy`` floor, for both the full FALCON
  ladder and the checkpoint-restart-only baseline.
* **JCT delay** (Table 7): per-job JCT inflation of the FALCON run over
  the healthy floor (the cost of living with faults + mitigation overhead).

``write_report`` persists the scored campaign as JSON that is
byte-identical for identical (preset, jobs, seed) inputs — pinned by the
determinism tests.

This is the twin of the reference's ``scenarios/scoring.py``. It departs
from the reference in one place only: its default output directory is
``build/repro_torch_results/campaigns`` (:data:`RESULTS_DIR`), never the
committed ``results/campaigns/`` that the reference writes and the port's
reports are compared against.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

from repro_torch.cluster.injector import HANG_KINDS
from repro_torch.cluster.traces import episodes_from_injections
from repro_torch.controlplane import (
    Diagnosis,
    Membership,
    MitigationResult,
    WatchdogAlarm,
    event_log_records,
)
from repro_torch.core.detector import FalconDetect, FleetDetect
from repro_torch.core.events import RootCause
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

#: episodes below this modeled impact are invisible even in principle and
#: are excluded from the recall denominator (strict ground truth)...
DETECT_IMPACT = 0.15
#: ...while anything above this may legitimately trip the 10 % verifier, so
#: diagnoses matching such an episode are true positives (loose matching)
MATCH_IMPACT = 0.05

#: default report directory — the port's own, so that a run never overwrites
#: the committed reference reports under ``results/``
RESULTS_DIR = os.path.join("build", "repro_torch_results", "campaigns")

# Ground-truth windows mirror the detector configuration the campaign runs
# with (the FleetDetect/FalconDetect defaults) — deriving them keeps the
# scorer honest if the detector tuning moves.
#: ticks after a job joins before its stream is screenable: fleet warmup
#: plus the verification half-window
WARM_TICKS = FleetDetect.warmup + FleetDetect.verify_window // 2 + 2
#: the drift screen's reference lag: ramps slower than threshold/lag are
#: invisible to the lagged comparison
DRIFT_REF_TICKS = FleetDetect.drift_ref
#: episodes closer than the revalidation cadence merge into one incident
MERGE_GAP_TICKS = FalconDetect.revalidate_every + 2


@dataclass
class _Candidate:
    """One (episode, job) pair in matching form."""

    global_id: int
    kind_cause: RootCause
    impact: float
    start: float
    end: float
    detectable_from: float
    expected: bool


def _cause_bucket(cause: RootCause) -> str:
    return cause.value


def _cause_compatible(diag: Diagnosis, cand: "_Candidate") -> bool:
    """Whether a diagnosis can stand for a ground-truth episode's cause.

    UNKNOWN is compound/unattributed and matches anything. So does a
    CPU_CONTENTION diagnosis with *no components*: the detector assigns it
    by elimination when validation finds no guilty part — which is exactly
    what happens for faults inside the validation blind band (e.g. a GPU
    throttled by ~20 %: iteration impact clears the 10 % verifier but the
    GEMM ratio 1/0.8 = 1.25 stays under the 1.3x component threshold). The
    detection is real; only the localization failed, and the per-cause
    table still shows where attribution landed.
    """
    cause = diag.event.root_cause
    if cause is RootCause.UNKNOWN:
        return True
    if cause is RootCause.CPU_CONTENTION and not diag.event.components:
        return True
    return cause is cand.kind_cause


def _candidates_for_job(
    placed, outcome, dt: float
) -> list[_Candidate]:
    warm_s = WARM_TICKS * dt
    min_visible_s = 10.0 * dt
    job_end = outcome.end_time if outcome.end_time is not None else float("inf")
    out: list[_Candidate] = []
    for gid, local, impact in zip(
        placed.global_ids, placed.local_schedule, placed.impacts
    ):
        if impact < MATCH_IMPACT:
            continue
        ramp_frac = min(1.0, 0.10 / impact) if local.ramp > 0 else 0.0
        detectable_from = local.start + local.ramp * ramp_frac
        # A ramp slower than the drift screen's reference lag never shows a
        # windowed shift of the full impact — only the part the lagged
        # comparison can see counts toward detectability.
        windowed = impact
        if local.ramp > 0:
            windowed = impact * min(1.0, DRIFT_REF_TICKS * dt / local.ramp)
        expected = (
            windowed >= DETECT_IMPACT
            and detectable_from >= outcome.join_time + warm_s
            and min(local.end, job_end) - detectable_from >= min_visible_s
        )
        out.append(_Candidate(
            global_id=gid,
            kind_cause=KIND_CAUSE[local.kind],
            impact=impact,
            start=local.start,
            end=min(local.end, job_end),
            detectable_from=detectable_from,
            expected=expected,
        ))
    return out


def _merge_episodes(
    cands: list[_Candidate], dt: float
) -> list[list[_Candidate]]:
    """Group expected candidates whose spans (+ a revalidation gap) overlap:
    the detector reports a compound pile-up as one incident chain."""
    gap = MERGE_GAP_TICKS * dt
    expected = sorted(
        (c for c in cands if c.expected), key=lambda c: c.detectable_from
    )
    groups: list[list[_Candidate]] = []
    for c in expected:
        if groups and c.detectable_from <= max(
            m.end for m in groups[-1]
        ) + gap:
            groups[-1].append(c)
        else:
            groups.append([c])
    return groups


def score_campaign(
    spec: CampaignSpec,
    runs: dict[str, RunResult],
    observation_stride: int = 0,
) -> dict:
    """Score a campaign's four runs into the paper-metric report dict.

    ``observation_stride`` opts the report's event log into sampled
    :class:`Observation` records (every Nth per job — a plottable
    iteration-time lane); the default ``0`` keeps the historical
    Observation-free log byte for byte. See
    :func:`~repro_torch.controlplane.events.event_log_records`.
    """
    preset = spec.preset
    dt = preset.tick_seconds
    horizon = preset.max_ticks * dt
    falcon = runs["falcon"]
    grace = 20.0 * dt

    # ---------------------------------------------------- detection
    diags_by_job: dict[str, list[Diagnosis]] = {}
    for ev in falcon.events:
        if isinstance(ev, Diagnosis) and not ev.resolved:
            diags_by_job.setdefault(ev.job_id, []).append(ev)

    per_cause: dict[str, dict] = {}

    def bucket(name: str) -> dict:
        return per_cause.setdefault(
            name,
            {"tp": 0, "fp": 0, "episodes": 0, "detected": 0, "latencies": []},
        )

    detected_gids: dict[int, list[str]] = {}
    episode_rows: list[dict] = []
    diag_rows: list[dict] = []
    for placed in spec.jobs:
        outcome = falcon.outcomes[placed.job_id]
        cands = _candidates_for_job(placed, outcome, dt)
        diags = diags_by_job.get(placed.job_id, [])

        # Precision: every onset diagnosis must trace back to a visible
        # ground-truth episode of the matching cause.
        for diag in diags:
            cause = diag.event.root_cause
            matched = any(
                _cause_compatible(diag, c)
                and c.start - 2 * dt <= diag.time <= c.end + grace
                for c in cands
            )
            b = bucket(_cause_bucket(cause))
            b["tp" if matched else "fp"] += 1
            diag_rows.append({
                "job_id": placed.job_id,
                "time_s": round(diag.time, 2),
                "cause": cause.value,
                "components": list(diag.event.components),
                "deduped_from": diag.deduped_from,
                "matched": matched,
            })

        # Recall + latency over merged expected episodes.
        for group in _merge_episodes(cands, dt):
            causes = {c.kind_cause for c in group}
            name = (
                _cause_bucket(next(iter(causes)))
                if len(causes) == 1 else "mixed"
            )
            b = bucket(name)
            b["episodes"] += 1
            t_from = min(c.detectable_from for c in group)
            hit_times = [
                diag.time
                for diag in diags
                for c in group
                if _cause_compatible(diag, c)
                and c.start - 2 * dt <= diag.time <= c.end + grace
            ]
            row = {
                "job_id": placed.job_id,
                "causes": sorted(c.value for c in causes),
                "injections": sorted({c.global_id for c in group}),
                "detectable_from_s": round(t_from, 3),
                "detected": bool(hit_times),
                "latency_s": (
                    round(max(0.0, min(hit_times) - t_from), 3)
                    if hit_times else None
                ),
            }
            episode_rows.append(row)
            if hit_times:
                b["detected"] += 1
                b["latencies"].append(max(0.0, min(hit_times) - t_from))
                for c in group:
                    detected_gids.setdefault(c.global_id, []).append(
                        placed.job_id
                    )

    def _finalize(agg: dict) -> dict:
        tp, fp = agg["tp"], agg["fp"]
        lat = sorted(agg["latencies"])
        return {
            "diagnoses": tp + fp,
            "true_positives": tp,
            "false_positives": fp,
            "precision": round(tp / (tp + fp), 4) if tp + fp else None,
            "episodes": agg["episodes"],
            "detected": agg["detected"],
            "recall": (
                round(agg["detected"] / agg["episodes"], 4)
                if agg["episodes"] else None
            ),
            "latency_mean_s": (
                round(sum(lat) / len(lat), 3) if lat else None
            ),
            "latency_p90_s": (
                round(lat[min(len(lat) - 1, int(0.9 * len(lat)))], 3)
                if lat else None
            ),
        }

    overall = {
        "tp": sum(b["tp"] for b in per_cause.values()),
        "fp": sum(b["fp"] for b in per_cause.values()),
        "episodes": sum(b["episodes"] for b in per_cause.values()),
        "detected": sum(b["detected"] for b in per_cause.values()),
        "latencies": [
            v for b in per_cause.values() for v in b["latencies"]
        ],
    }
    detection = {
        "overall": _finalize(overall),
        "per_cause": {k: _finalize(v) for k, v in sorted(per_cause.items())},
    }

    # ---------------------------------------------------- mitigation
    job_rows: list[dict] = []
    gap_total = 0.0
    falcon_recovered = 0.0
    ckpt_recovered = 0.0
    delay_pcts: list[float] = []
    #: cause -> apportioned [slowdown_s, mitigated_s] (estimates: each
    #: job's JCT gap is split over its episodes by impact x lifetime
    #: overlap; the what-if engine's leave-one-out attribution is the
    #: counterfactual ground truth these estimates approximate)
    cause_split: dict[str, list[float]] = {}
    for placed in spec.jobs:
        jcts = {
            mode: runs[mode].outcomes[placed.job_id].jct(horizon)
            for mode in runs
        }
        finished = {
            mode: runs[mode].outcomes[placed.job_id].finished for mode in runs
        }
        gap = jcts["faults"] - jcts["healthy"]
        mitigated = jcts["faults"] - jcts["falcon"]
        mitigated_ckpt = jcts["faults"] - jcts.get("ckpt", jcts["faults"])
        if gap > 1e-9:
            gap_total += gap
            falcon_recovered += mitigated
            ckpt_recovered += mitigated_ckpt
            out_f = runs["faults"].outcomes[placed.job_id]
            end_f = (
                out_f.end_time if out_f.end_time is not None else horizon
            )
            weights: list[tuple[str, float]] = []
            for local, impact in zip(placed.local_schedule, placed.impacts):
                overlap = max(
                    0.0, min(local.end, end_f) - max(local.start, out_f.join_time)
                )
                w = impact * overlap
                if w > 0.0:
                    weights.append((KIND_CAUSE[local.kind].value, w))
            total_w = sum(w for _, w in weights)
            for cause, w in weights:
                share = w / total_w if total_w > 0 else 0.0
                acc = cause_split.setdefault(cause, [0.0, 0.0])
                acc[0] += gap * share
                acc[1] += mitigated * share
        delay_pct = 100.0 * (jcts["falcon"] - jcts["healthy"]) / jcts["healthy"]
        delay_pcts.append(delay_pct)
        t = placed.template
        job_rows.append({
            "job_id": placed.job_id,
            "arch": t.arch,
            "parallelism": f"tp{t.tp}xdp{t.dp}xpp{t.pp}",
            "devices": list(placed.devices),
            "nodes": list(placed.nodes),
            "join_tick": placed.join_tick,
            "steps": placed.steps,
            "healthy_iter_time_s": round(placed.healthy_iter_time, 4),
            "jct_s": {m: round(v, 2) for m, v in sorted(jcts.items())},
            "finished": finished,
            "jct_delay_pct": round(delay_pct, 3),
            "slowdown_mitigated_pct": (
                round(100.0 * mitigated / gap, 2) if gap > 1e-9 else None
            ),
            "mitigations": dict(sorted(
                falcon.outcomes[placed.job_id].mitigations.items()
            )),
            "ground_truth_ticks": [
                {
                    "onset": ep.onset, "relief": ep.relief,
                    "severity": round(ep.severity, 3), "ramp": ep.ramp,
                }
                for ep in episodes_from_injections(
                    placed.local_schedule, dt, preset.max_ticks
                )
            ],
        })

    mitigation = {
        "slowdown_mitigated_pct": (
            round(100.0 * falcon_recovered / gap_total, 2)
            if gap_total > 1e-9 else None
        ),
        "slowdown_mitigated_ckpt_pct": (
            round(100.0 * ckpt_recovered / gap_total, 2)
            if gap_total > 1e-9 else None
        ),
        "avg_jct_delay_pct": round(
            sum(delay_pcts) / len(delay_pcts), 3
        ) if delay_pcts else None,
        "paper_slowdown_mitigated_pct": 60.1,
        "paper_avg_jct_delay_pct": 1.34,
        "per_cause": {
            cause: {
                "slowdown_s": round(g, 2),
                "mitigated_s": round(m, 2),
                "mitigated_pct": round(100.0 * m / g, 2) if g > 1e-9 else None,
            }
            for cause, (g, m) in sorted(cause_split.items())
        },
    }

    # ---------------------------------------------------- robustness
    # Hang anomalies (watchdog path) + the fault-tolerant executor. Scored
    # from the falcon run's typed event log: WatchdogAlarm marks detection,
    # an applied ABORT_REFORM / CKPT_AND_RESTART inside the hang's window
    # ends it, and per-attempt MitigationResult statuses expose every
    # executor failure, retry, rollback and quarantine.
    alarms = [ev for ev in falcon.events if isinstance(ev, WatchdogAlarm)]
    aborts: dict[str, list[float]] = {}
    exec_counts = {"ok": 0, "failed": 0, "timed_out": 0, "rolled_back": 0}
    retries = 0
    quarantines = 0
    errors = 0
    for ev in falcon.events:
        if not isinstance(ev, MitigationResult):
            continue
        if ev.kind == "error":
            errors += 1
            continue
        if ev.kind != "mitigate":
            continue
        exec_counts[ev.status] = exec_counts.get(ev.status, 0) + 1
        if ev.attempt > 1:
            retries += 1
        if ev.detail.get("quarantined"):
            quarantines += 1
        label = (
            ev.strategy.name
            if hasattr(ev.strategy, "name") else str(ev.strategy)
        )
        if ev.applied and label in ("ABORT_REFORM", "CKPT_AND_RESTART"):
            aborts.setdefault(ev.job_id, []).append(ev.time)

    hang_rows: list[dict] = []
    tta: list[float] = []
    alarm_windows: dict[str, list[tuple[float, float]]] = {}
    def _live_during(job_id: str, inj) -> bool:
        # Observability: a hang only counts against the watchdog if the
        # job's falcon-run lifetime overlaps it — a job that finished
        # before the hang started never went silent.
        out = falcon.outcomes[job_id]
        end = out.end_time if out.end_time is not None else float("inf")
        return out.join_time < inj.end and inj.start < end

    for gi, inj in enumerate(spec.schedule):
        if inj.kind not in HANG_KINDS:
            continue
        affected = sorted(
            p.job_id for p in spec.jobs
            if gi in p.global_ids and _live_during(p.job_id, inj)
        )
        if not affected:
            continue
        lo, hi = inj.start, inj.end + grace
        for j in affected:
            alarm_windows.setdefault(j, []).append((lo, hi))
        hit = [
            a.time for a in alarms
            if a.job_id in affected and lo <= a.time <= hi
        ]
        abort_times = [
            t for j in affected for t in aborts.get(j, []) if lo <= t <= hi
        ]
        if abort_times:
            tta.append(min(abort_times) - inj.start)
        hang_rows.append({
            "injection_id": gi,
            "kind": inj.kind.value,
            "scope": inj.scope,
            "jobs": affected,
            "start_s": round(inj.start, 2),
            "alarmed": bool(hit),
            "alarm_latency_s": (
                round(min(hit) - inj.start, 3) if hit else None
            ),
            "time_to_abort_s": (
                round(min(abort_times) - inj.start, 3)
                if abort_times else None
            ),
        })
    false_alarms = sum(
        1 for a in alarms
        if not any(
            lo <= a.time <= hi
            for lo, hi in alarm_windows.get(a.job_id, [])
        )
    )
    tta.sort()
    n_hangs = len(hang_rows)
    n_alarmed = sum(1 for r in hang_rows if r["alarmed"])
    robustness = {
        "watchdog": {
            "alarms": len(alarms),
            "hangs_injected": n_hangs,
            "hangs_detected": n_alarmed,
            "hang_detection_rate": (
                round(n_alarmed / n_hangs, 4) if n_hangs else None
            ),
            "false_alarms": false_alarms,
            "median_time_to_abort_s": (
                round(tta[len(tta) // 2], 3) if tta else None
            ),
            "deadline_budget_s": round(preset.abort_budget_ticks * dt, 2),
            "hangs": hang_rows,
        },
        "executor": {
            "dispatch_results": dict(sorted(exec_counts.items())),
            "retries": retries,
            "quarantines": quarantines,
            "uncaught_errors": errors,
        },
        # GPU-seconds burned while a job sat fully stalled — the paper's
        # wasted-accelerator-time cost of hangs; mitigation shrinks it.
        "wasted_gpu_time_s": {
            mode: round(
                sum(
                    runs[mode].outcomes[p.job_id].stalled_ticks
                    * dt * len(p.devices)
                    for p in spec.jobs
                ), 2,
            )
            for mode in sorted(runs)
        },
    }

    # ---------------------------------------------------- assembled report
    inj_rows = [
        {
            "id": gi,
            "kind": inj.kind.value,
            "target": list(inj.target),
            "start_s": round(inj.start, 2),
            "duration_s": round(inj.duration, 2),
            "severity": round(inj.severity, 3),
            "ramp_s": round(inj.ramp, 2),
            "affected_jobs": sorted(
                p.job_id for p in spec.jobs if gi in p.global_ids
            ),
            "detected_by": sorted(set(detected_gids.get(gi, []))),
        }
        for gi, inj in enumerate(spec.schedule)
    ]
    membership = [
        {"time_s": round(ev.time, 2), "job_id": ev.job_id, "action": ev.action}
        for ev in falcon.events
        if isinstance(ev, Membership)
    ]
    # The replayable fleet event log (what-if input): every falcon-run
    # flag, diagnosis, action and result, with timestamps. Observations
    # are dropped by default — they dominate the log (one per job per
    # tick) and the replay re-derives them from (preset, seed) anyway —
    # unless the caller opts into a sampled stride.
    event_log = event_log_records(
        falcon.events, observation_stride=observation_stride
    )
    event_counts: dict[str, int] = {}
    for ev in falcon.events:
        name = type(ev).__name__
        event_counts[name] = event_counts.get(name, 0) + 1

    return {
        "campaign": {
            "preset": preset.name,
            "description": preset.description,
            "seed": spec.seed,
            "n_jobs": len(spec.jobs),
            "n_nodes": spec.n_nodes,
            "gpus_per_node": preset.gpus_per_node,
            "tick_seconds": dt,
            "max_ticks": preset.max_ticks,
            "ticks_run": {m: runs[m].ticks_run for m in sorted(runs)},
            "n_injections": len(spec.schedule),
        },
        "detection": detection,
        "diagnoses": diag_rows,
        "episodes": episode_rows,
        "mitigation": mitigation,
        "robustness": robustness,
        "jobs": job_rows,
        "injections": inj_rows,
        "membership": membership,
        "event_log": event_log,
        "falcon_event_counts": dict(sorted(event_counts.items())),
    }


def run_and_score(
    preset: str,
    n_jobs: int | None = None,
    seed: int = 0,
    max_ticks: int | None = None,
    obs: bool = False,
    observation_stride: int = 0,
    screening_backend: str | None = None,
    reduction_backend: str | None = None,
    engine: CampaignEngine | None = None,
    fresh: bool = False,
    device=None,
) -> tuple[CampaignSpec, dict[str, RunResult], dict]:
    """Build a campaign, execute all four modes, and score it.

    The four modes run on a shared-prefix :class:`CampaignEngine` — one
    recorded timeline, plane modes forked at their divergence point —
    byte-identical to four independent :func:`run_campaign` executions
    (the engine's headline invariant).
    Pass ``fresh=True`` to force the independent executions anyway, or
    ``engine=`` to reuse a caller-owned engine (its spec supersedes the
    identity arguments; further ``run()`` calls share its mode tree).

    ``obs=True`` turns the observability layer on for the falcon run: a
    :class:`repro_torch.obs.SpanTracer` rides the campaign clock (returned on
    ``runs["falcon"].tracer``), ready for
    :func:`repro_torch.obs.recorder.write_sidecars`. Only that falcon run
    executes fresh (the tracer wants the real control flow); the scored
    report is byte-identical either way — tracing never alters the run.

    ``screening_backend`` / ``reduction_backend`` override the fleet
    screen's and the simulators' compute backends (registry names of
    :data:`repro_torch.core.bocd.SCREENING_BACKENDS` and
    :data:`repro_torch.cluster.simulator.REDUCTION_BACKENDS`); None keeps the
    defaults (``auto``). Backend overrides disable the engine (its snapshots
    only cover the default backends' state).

    ``device`` is where the simulators and the fleet screen run: None is the
    card (``auto`` = the CUDA ``bocd_step`` screen in float32 and
    ``CudaReduction``) and raises a RuntimeError naming ``device="cpu"``
    when there is none; ``"cpu"`` gives the plain ``torch`` screen in
    float64 and ``TorchReduction``. A caller-owned ``engine`` keeps its own
    device.
    """
    if engine is not None:
        spec, device = engine.spec, engine.device
    else:
        device = resolve_device(device)
        spec = build_campaign(
            preset, n_jobs=n_jobs, seed=seed, max_ticks=max_ticks,
            device=device,
        )
    use_engine = (
        not fresh and screening_backend is None and reduction_backend is None
    )
    if use_engine and engine is None:
        engine = CampaignEngine(spec, device=device)
    runs = {}
    for mode in MODES:
        tracer = None
        if obs and mode == "falcon":
            from repro_torch.obs import SpanTracer

            tracer = SpanTracer()
        if use_engine and tracer is None:
            runs[mode] = engine.run(mode)
            continue
        runs[mode] = run_campaign(
            spec, mode, tracer=tracer,
            screening_backend=screening_backend,
            reduction_backend=reduction_backend,
            device=device,
        )
    return spec, runs, score_campaign(
        spec, runs, observation_stride=observation_stride
    )


def write_report(report: dict, out_dir: str = RESULTS_DIR) -> str:
    """Persist a campaign report; the filename encodes (preset, jobs, seed).

    Serialization is canonical (sorted keys, fixed float rounding applied
    upstream, no timestamps), so identical campaigns produce byte-identical
    files — the determinism contract the tests pin.
    """
    os.makedirs(out_dir, exist_ok=True)
    c = report["campaign"]
    path = os.path.join(
        out_dir, f"{c['preset']}-j{c['n_jobs']}-s{c['seed']}.json"
    )
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    return path
