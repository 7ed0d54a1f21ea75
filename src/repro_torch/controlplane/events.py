"""Typed events of the FALCON control plane.

The control plane's public contract is an event pipeline

    Observation -> Flag -> Diagnosis -> MitigationAction -> MitigationResult

extending the detection-layer types in :mod:`repro_torch.core.events`: a
:class:`Flag` wraps the verified :class:`~repro_torch.core.events.ChangePoint` the
fleet screen produced, a :class:`Diagnosis` wraps the pinpointed
:class:`~repro_torch.core.events.FailSlowEvent`, and mitigation events carry the
:data:`~repro_torch.core.events.StrategyKey` that was dispatched through the
strategy registry. Every event is timestamped on the *job's* clock (the
trainer's simulated wall clock, a trace's replay cursor, or real
``time.monotonic`` on hardware) so a control-plane log is coherent across
sources — see docs/control_plane.md.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields

from repro_torch.core.events import ChangePoint, FailSlowEvent, StrategyKey, strategy_label


@dataclass(frozen=True)
class ControlEvent:
    """Base class: everything the control plane emits names a job + time."""

    job_id: str
    time: float


@dataclass(frozen=True)
class Observation(ControlEvent):
    """One iteration-time sample ingested for a registered job."""

    iter_time: float
    step: int = 0


@dataclass(frozen=True)
class Membership(ControlEvent):
    """A job joined or left the control plane (dynamic fleet churn).

    Emitted by :meth:`ControlPlane.register_job` / ``remove_job`` so the
    event log alone reconstructs which jobs were live at any time — the
    campaign scoring layer reads join/leave times from here.
    """

    action: str = "join"  # "join" | "leave"


@dataclass(frozen=True)
class ScreenTuning(ControlEvent):
    """The fleet screen re-derived its adaptive knobs (fleet-scoped:
    ``job_id`` is empty).

    Emitted by :meth:`ControlPlane.tick` whenever the
    :class:`~repro_torch.core.detector.FleetDetect` adaptive layer
    (``adapt_every > 0``) chooses new values: the per-worker hazard and the
    shared run-length frontier cap derived from the observed confirmed-flag
    rate (``change_rate`` = flags / worker-ticks at re-tune time). The log
    therefore records exactly which screening parameters were live for
    every subsequent Flag.
    """

    hazard: float = 0.0
    max_hypotheses: int | None = None
    change_rate: float = 0.0
    flags: int = 0
    worker_ticks: int = 0


@dataclass(frozen=True)
class Flag(ControlEvent):
    """A verified change-point from the fleet screen (pre-pinpoint).

    Emitted only on the screening path (:meth:`ControlPlane.tick`); the
    exact per-job path verifies inside ``FalconDetect.observe`` and emits a
    :class:`Diagnosis` directly.
    """

    change_point: ChangePoint


@dataclass(frozen=True)
class Diagnosis(ControlEvent):
    """A pinpointed (or deduped) fail-slow incident for one job.

    ``components_global`` are the job's slow components translated through
    its hardware map (shared-hardware identity across jobs);
    ``deduped_from`` names the job whose pinpoint this diagnosis reuses —
    ``None`` when this job ran profiling + validation itself.

    ``breakdown`` is the per-collective timing decomposition
    (:class:`repro_torch.obs.collectives.CollectiveBreakdown`) of the job's
    iteration at diagnosis time, when the adapter can produce one — it
    names the bottleneck collective and ring edge a hang or link fault
    stalled. The field is *transient* (``metadata={"transient": True}``):
    :func:`event_record` skips it, so committed campaign reports are
    byte-stable; the observability sidecars (trace spans, metrics) carry
    the decomposition instead. See docs/observability.md.
    """

    event: FailSlowEvent
    components_global: tuple[str, ...] = ()
    deduped_from: str | None = None
    resolved: bool = False
    breakdown: object | None = field(
        default=None, compare=False, metadata={"transient": True}
    )


@dataclass(frozen=True)
class MitigationAction(ControlEvent):
    """The planner escalated: dispatch ``strategy`` for ``event`` now."""

    strategy: StrategyKey
    event: FailSlowEvent


@dataclass(frozen=True)
class WatchdogAlarm(ControlEvent):
    """A job's sample stream went silent past its calibrated deadline.

    Emitted by :meth:`ControlPlane.tick` when the heartbeat watchdog
    expires for a registered job that produced no observation — the hang
    signature BOCD structurally cannot flag. ``last_seen`` is the job clock
    of the final heartbeat, ``deadline_s`` the jitter-calibrated silence
    budget that was exceeded, ``silence_s`` the actual silence at alarm
    time.
    """

    last_seen: float = 0.0
    deadline_s: float = 0.0
    silence_s: float = 0.0


@dataclass(frozen=True)
class MitigationResult(ControlEvent):
    """Outcome of one strategy dispatch attempt (or a relief rebalance).

    ``overhead`` is the one-off action cost the caller must charge to the
    job's wall clock; ``detail`` carries strategy-specific payload (e.g. the
    new micro-batch allocation) for the caller's runtime to mirror.

    Failure semantics (docs/control_plane.md): ``status`` is ``"ok"`` for a
    successful dispatch, ``"failed"`` / ``"timed_out"`` for one rolled-back
    attempt (the executor emits one result per attempt, ``attempt`` counting
    from 1), and ``"rolled_back"`` for the terminal result of a dispatch
    whose retries were exhausted — the job state is guaranteed back at the
    pre-action snapshot whenever ``detail["rolled_back"]`` is true.
    """

    strategy: StrategyKey | None
    applied: bool
    overhead: float = 0.0
    kind: str = "mitigate"  # "mitigate" | "relief" | "error" | "suppressed"
    detail: dict = field(default_factory=dict)
    status: str = "ok"  # "ok" | "failed" | "timed_out" | "rolled_back"
    attempt: int = 1


# --------------------------------------------------------- serialization
def _jsonify(value):
    """Deterministic JSON-safe view of an event field value.

    Floats are rounded (fixed precision keeps committed logs byte-stable
    across platforms), numpy scalars are unwrapped, enums become their
    labels, and nested dataclasses recurse through :func:`event_record`'s
    field walk.
    """
    if isinstance(value, enum.Enum):
        return strategy_label(value) if value.__class__.__name__ == "Strategy" \
            else value.value
    if isinstance(value, bool) or value is None or isinstance(value, (int, str)):
        return value
    if isinstance(value, float):
        return round(float(value), 6)
    if hasattr(value, "item") and not isinstance(value, (list, tuple, dict)):
        return _jsonify(value.item())  # numpy scalar
    if isinstance(value, dict):
        return {str(k): _jsonify(v) for k, v in sorted(value.items(), key=lambda kv: str(kv[0]))}
    if isinstance(value, (list, tuple, set, frozenset)):
        seq = sorted(value, key=str) if isinstance(value, (set, frozenset)) else value
        return [_jsonify(v) for v in seq]
    if hasattr(value, "__dataclass_fields__"):
        return {
            f.name: _jsonify(getattr(value, f.name))
            for f in fields(value)
        }
    return str(value)


def event_record(ev: ControlEvent) -> dict:
    """One control-plane event as a deterministic, JSON-safe dict.

    The replayable fleet event log: a campaign report that stores
    ``[event_record(e) for e in plane.events]`` carries every flag,
    diagnosis, action, and result with timestamps, which is sufficient
    input for the what-if engine (:mod:`repro_torch.whatif`) to rebuild the
    decision schedule without re-running the campaign. ``type`` is the
    event class name; strategy keys serialize via
    :func:`~repro_torch.core.events.strategy_label` so enum and string-keyed
    strategies round-trip uniformly. :class:`Observation` events are the
    caller's to filter — at fleet scale they dominate the log but carry
    no decision, so the campaign scorer drops them.
    """
    rec = {"type": type(ev).__name__}
    for f in fields(ev):
        if f.metadata.get("transient"):
            # Observability-only payload (e.g. Diagnosis.breakdown):
            # excluded so committed event logs stay byte-stable across
            # the observability layer's evolution; sidecars carry it.
            continue
        rec[f.name] = _jsonify(getattr(ev, f.name))
    return rec


def event_log_records(
    events, observation_stride: int = 0
) -> list[dict]:
    """Serialize an event stream into report-ready records.

    :class:`Observation` events are elided by default — at fleet scale
    they dominate the log (one per job per tick) and carry no decision —
    which also blanks a dashboard's timeline lanes between flags.
    ``observation_stride=N`` opts in to keeping every Nth Observation per
    job: a sampled iteration-time lane dense enough to plot, cheap enough
    to commit. ``0`` (the default) reproduces the historical
    Observation-free log byte for byte.
    """
    out: list[dict] = []
    seen: dict[str, int] = {}
    for ev in events:
        if isinstance(ev, Observation):
            if observation_stride <= 0:
                continue
            k = seen.get(ev.job_id, 0)
            seen[ev.job_id] = k + 1
            if k % observation_stride:
                continue
        out.append(event_record(ev))
    return out
