"""Campaign recorder — feed a :class:`MetricsRegistry` from a scored run.

Sits *above* the control plane and scenarios layers (import it
explicitly: ``from repro_torch.obs import recorder`` — it is deliberately not
re-exported from :mod:`repro_torch.obs`). Two entry points:

* :func:`record_campaign` — walk the falcon run's typed event pipeline
  plus the scored report and populate the full metric catalog
  (the reference's account is docs/observability.md):
  event/diagnosis/mitigation counters, executor
  retry/quarantine totals, detection-latency and time-to-mitigate
  histograms, wasted-GPU-seconds and headline gauges.
* :func:`write_sidecars` — persist the observability sidecars next to a
  campaign report: ``<preset>-j<n>-s<seed>.trace.json`` (the falcon
  run's span trace, Chrome/Perfetto format) and ``....metrics.json``
  (the registry snapshot). Both are byte-deterministic for identical
  (preset, jobs, seed) inputs, like the report itself.
"""
from __future__ import annotations

import os

from repro_torch.controlplane.events import (
    Diagnosis,
    MitigationResult,
    WatchdogAlarm,
)
from repro_torch.core.events import strategy_label
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["record_campaign", "write_sidecars"]


def record_campaign(spec, runs, report) -> MetricsRegistry:
    """Populate a registry from a campaign's runs + scored report.

    ``spec``/``runs``/``report`` are :func:`repro_torch.scenarios.scoring
    .run_and_score` outputs. Everything recorded is a pure function of
    them, so two runs of the same campaign snapshot byte-identically.
    """
    reg = MetricsRegistry()
    falcon = runs["falcon"]

    # ------------------------------------------------ event-stream walk
    #: job_id -> time of its latest un-mitigated onset diagnosis (the
    #: time-to-mitigate clock; cleared by the first applied dispatch)
    onset_at: dict[str, tuple[float, str]] = {}
    for ev in falcon.events:
        reg.counter("events_total", type=type(ev).__name__).inc()
        if isinstance(ev, Diagnosis):
            if ev.resolved:
                continue
            cause = ev.event.root_cause.value
            reg.counter("diagnoses_total", cause=cause, job=ev.job_id).inc()
            if ev.deduped_from is not None:
                reg.counter("diagnoses_deduped_total").inc()
            if ev.job_id not in onset_at:
                onset_at[ev.job_id] = (ev.time, cause)
            bd = ev.breakdown
            if bd is not None:
                reg.counter(
                    "diagnosis_bottleneck_total", collective=bd.bottleneck
                ).inc()
        elif isinstance(ev, WatchdogAlarm):
            reg.counter("watchdog_alarms_total", job=ev.job_id).inc()
            reg.histogram("watchdog_silence_s").observe(ev.silence_s)
        elif isinstance(ev, MitigationResult):
            if ev.kind == "relief":
                reg.counter("relief_total").inc()
                continue
            if ev.kind == "suppressed":
                reg.counter("suppressed_total").inc()
                continue
            if ev.kind == "error":
                reg.counter("executor_errors_total").inc()
                continue
            label = strategy_label(ev.strategy) if ev.strategy else "none"
            reg.counter(
                "mitigation_attempts_total", strategy=label, status=ev.status
            ).inc()
            if ev.attempt > 1:
                reg.counter("executor_retries_total").inc()
            if ev.detail.get("quarantined") and ev.status == "rolled_back":
                reg.counter("executor_quarantines_total").inc()
            if ev.overhead:
                reg.counter(
                    "mitigation_overhead_s_total", job=ev.job_id
                ).inc(ev.overhead)
            if ev.applied:
                reg.counter("mitigations_applied_total", strategy=label).inc()
                pending = onset_at.pop(ev.job_id, None)
                if pending is not None:
                    t0, cause = pending
                    reg.histogram(
                        "time_to_mitigate_s", cause=cause
                    ).observe(max(ev.time - t0, 0.0))

    # ------------------------------------------------ scored-report walk
    for row in report["episodes"]:
        causes = row["causes"]
        cause = causes[0] if len(causes) == 1 else "mixed"
        if row["detected"] and row["latency_s"] is not None:
            reg.histogram(
                "detection_latency_s", cause=cause
            ).observe(row["latency_s"])
        else:
            reg.counter("missed_episodes_total", cause=cause).inc()
    for row in report["injections"]:
        reg.histogram(
            "fault_duration_s", kind=row["kind"]
        ).observe(row["duration_s"])
    for row in report["robustness"]["watchdog"]["hangs"]:
        if row["time_to_abort_s"] is not None:
            reg.histogram("time_to_abort_s").observe(row["time_to_abort_s"])

    mit = report["mitigation"]
    if mit["slowdown_mitigated_pct"] is not None:
        reg.gauge("slowdown_mitigated_pct", mode="falcon").set(
            mit["slowdown_mitigated_pct"]
        )
    if mit["slowdown_mitigated_ckpt_pct"] is not None:
        reg.gauge("slowdown_mitigated_pct", mode="ckpt").set(
            mit["slowdown_mitigated_ckpt_pct"]
        )
    if mit["avg_jct_delay_pct"] is not None:
        reg.gauge("avg_jct_delay_pct").set(mit["avg_jct_delay_pct"])
    for mode, wasted in report["robustness"]["wasted_gpu_time_s"].items():
        reg.gauge("wasted_gpu_seconds", mode=mode).set(wasted)
    rate = report["robustness"]["watchdog"]["hang_detection_rate"]
    if rate is not None:
        reg.gauge("hang_detection_rate").set(rate)
    for row in report["jobs"]:
        reg.gauge("jct_delay_pct", job=row["job_id"]).set(
            row["jct_delay_pct"]
        )
    return reg


def write_sidecars(spec, runs, report, out_dir=None) -> dict[str, str]:
    """Write the trace/metrics sidecars next to a campaign report.

    Returns ``{"trace": path, "metrics": path}`` (the trace entry is
    omitted when the falcon run carried no tracer). The base name matches
    :func:`repro_torch.scenarios.scoring.write_report`, so
    ``<base>.json`` / ``<base>.trace.json`` / ``<base>.metrics.json``
    sit side by side.
    """
    from repro_torch.scenarios.scoring import RESULTS_DIR

    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    c = report["campaign"]
    base = os.path.join(
        out_dir, f"{c['preset']}-j{c['n_jobs']}-s{c['seed']}"
    )
    paths: dict[str, str] = {}
    tracer = getattr(runs.get("falcon"), "tracer", None)
    if tracer is not None:
        paths["trace"] = f"{base}.trace.json"
        tracer.write(paths["trace"])
    reg = record_campaign(spec, runs, report)
    paths["metrics"] = f"{base}.metrics.json"
    reg.write(paths["metrics"])
    return paths
