"""ControlPlane — the unified monitor/detect/pinpoint/plan/mitigate loop.

One :class:`ControlPlane` owns any number of registered jobs and drives the
FALCON pipeline (paper §4-§5) for each of them through typed events
(:mod:`repro_torch.controlplane.events`). Two ingestion paths:

* :meth:`ControlPlane.observe` — exact per-job path: the job's
  :class:`~repro_torch.core.detector.FalconDetect` runs its own BOCD + verification
  on every sample. This is what :class:`repro_torch.train.trainer.FalconTrainer`
  drives; it reproduces the pre-control-plane trainer behavior decision for
  decision (equivalence-tested on the 64-GPU end-to-end scenario).
* :meth:`ControlPlane.tick` — fleet path: one
  :class:`~repro_torch.core.detector.FleetDetect` screens every registered job's
  stream per tick (shared batched-BOCD frontier, flat per-tick cost) and
  routes confirmed :class:`~repro_torch.core.detector.FleetFlag`s into that job's
  ``FalconDetect`` pinpointing. Jobs sharing hardware (the ``hardware``
  registration map) dedupe diagnoses: the first flagged job runs profiling +
  validation, later flags whose hardware overlaps an active diagnosis adopt
  its translated root cause instead of re-validating.

Mitigation is planned by the per-event ski-rental
:class:`~repro_torch.core.planner.MitigationPlanner` and dispatched through the
job's :class:`~repro_torch.controlplane.strategies.StrategyRegistry`, so new
strategies plug in without touching this orchestrator.
"""
from __future__ import annotations

from collections import deque
from collections.abc import Callable, Mapping, Sequence
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.detector import FalconDetect, FleetDetect, Watchdog
from repro_torch.core.duration import DurationModel
from repro_torch.core.events import (
    ChangePoint,
    FailSlowEvent,
    Strategy,
    StrategyKey,
    strategy_label,
)
from repro_torch.core.planner import MitigationPlanner, PlannerKnobs
from repro_torch.obs import runtime
from repro_torch.controlplane.events import (
    ControlEvent,
    Diagnosis,
    Flag,
    Membership,
    MitigationAction,
    MitigationResult,
    Observation,
    ScreenTuning,
    WatchdogAlarm,
)
from repro_torch.controlplane.strategies import (
    MitigationContext,
    StrategyRegistry,
    default_registry,
)


@dataclass(frozen=True)
class ExecutorPolicy:
    """Knobs of the fault-tolerant mitigation executor (docs/control_plane.md).

    Every strategy dispatch runs under this policy: up to ``max_attempts``
    tries, each against a fresh pre-action snapshot; a failed attempt is
    rolled back and retried after an exponential backoff
    (``backoff_base_s * 2**(attempt-1)``, charged to the job's clock); a
    timed-out attempt additionally charges ``timeout_s``. After
    ``quarantine_after`` consecutive failed attempts with no intervening
    success, the strategy is quarantined for this (job, root cause) and
    future ladders escalate past it.
    """

    max_attempts: int = 3
    backoff_base_s: float = 2.0
    timeout_s: float = 30.0
    quarantine_after: int = 3


@dataclass
class JobHandle:
    """One registered job: adapter + detector + strategy table + planner."""

    job_id: str
    adapter: object
    detector: FalconDetect
    registry: StrategyRegistry
    #: per-job overrides merged over the registry's default overheads
    overheads: dict = field(default_factory=dict)
    injector: object | None = None
    #: local device rank -> global hardware id (cross-job dedupe identity);
    #: None opts the job out of device-level dedupe
    hardware: tuple[str, ...] | None = None
    #: local node index -> global host id: the dedupe identity for
    #: node-scoped components (``node:`` host faults, ``nic:`` ports), which
    #: co-located jobs share even when their device sets are disjoint
    hosts: tuple[str, ...] | None = None
    #: seconds of wall clock one tick() sample stands for (fleet monitors
    #: scrape on a fixed cadence); None = one sample == one iteration, the
    #: per-iteration ``observe`` semantics
    sample_period: float | None = None
    #: remaining useful work of the job in wall-clock seconds — caps the
    #: benefit any mitigation can still deliver (the predictive ski-rental
    #: horizon is min(fault remaining, job remaining)); None = unbounded
    work_remaining: Callable[[], float] | None = None
    planner: MitigationPlanner | None = None
    steps: int = field(default=0)
    #: wall clock of this job's last checkpoint-restart (None = never)
    _last_restart: float | None = field(default=None, repr=False)
    #: set when a restart's bought healthy window did not even cover its
    #: own overhead — restarts cannot win in this fault environment, so
    #: S4 is withheld from later ladders for this job
    _s4_burned: bool = field(default=False, repr=False)
    #: this job's column in the fleet screen (None until the fleet exists)
    _fleet_col: int | None = field(default=None, repr=False)
    _ticks_active: int = field(default=0)
    #: global hardware id -> local rank (built once; hardware is immutable)
    _hw_inverse: dict[str, int] | None = field(default=None, repr=False)
    _host_inverse: dict[str, int] | None = field(default=None, repr=False)
    #: last delivered iteration-time sample and its job clock (the
    #: watchdog's flat-imputation source while the stream is silent)
    _last_sample: float = field(default=0.0, repr=False)
    _last_seen: float | None = field(default=None, repr=False)
    #: a watchdog alarm fired and has not yet been cleared by a heartbeat
    _alarmed: bool = field(default=False, repr=False)
    #: (root_cause, strategy) pairs the executor quarantined for this job
    _quarantined: set = field(default_factory=set, repr=False)
    #: (root_cause, strategy) -> consecutive failed dispatch attempts
    _fail_streaks: dict = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.hardware is not None:
            self._hw_inverse = {h: r for r, h in enumerate(self.hardware)}
        if self.hosts is not None:
            self._host_inverse = {h: n for n, h in enumerate(self.hosts)}

    def effective_overheads(self) -> dict:
        return self.registry.overheads(self.overheads)


class ControlPlane:
    """Multi-job FALCON orchestrator over typed control-plane events."""

    def __init__(
        self,
        fleet_kwargs: dict | None = None,
        max_events: int = 65536,
        duration_model: DurationModel | None = None,
        executor_policy: ExecutorPolicy | None = None,
        executor_faults: Callable | None = None,
        watchdog: Watchdog | None = None,
        decision_hook: object | None = None,
        planner_knobs: PlannerKnobs | None = None,
        planner_trace: list | None = None,
        tracer: object | None = None,
        screening_backend: object | None = None,
    ) -> None:
        self._jobs: dict[str, JobHandle] = {}
        self._fleet: FleetDetect | None = None
        self._fleet_kwargs = dict(fleet_kwargs or {})
        #: screening backend for the fleet screen: a registry name
        #: ("scalar"/"batched"/"torch"/"cuda"/"auto") or a
        #: :class:`repro_torch.core.bocd.ScreeningBackendFactory` instance —
        #: forwarded to :class:`FleetDetect`; None keeps FleetDetect's
        #: own default ("auto") or whatever ``fleet_kwargs`` says.
        if screening_backend is not None:
            self._fleet_kwargs["backend"] = screening_backend
        #: fault-tolerant executor knobs (retry/backoff/quarantine)
        self.executor_policy = executor_policy or ExecutorPolicy()
        #: injectable executor fault model: (job_id, strategy, attempt, now)
        #: -> None | "fail" | "timeout" — lets campaigns make mitigations
        #: themselves flaky (scenario engine's ExecutorFaultModel)
        self.executor_faults = executor_faults
        #: heartbeat watchdog over every registered job's sample stream
        self.watchdog = watchdog or Watchdog()
        #: counterfactual decision intercept (repro_torch.whatif replay contract):
        #: any object implementing a subset of
        #:   allow(job_id, strategy, now) -> bool       (False = suppress)
        #:   allow_relief(job_id, now) -> bool          (False = no relief)
        #:   forced(job_id, now) -> list[StrategyKey]   (dispatch these now)
        #: A suppressed decision emits a kind="suppressed" MitigationResult
        #: and neither touches the adapter nor consumes executor-fault
        #: randomness, so suppressing every decision replays the unmitigated
        #: run bit-exactly. None = every decision passes through.
        self.decision_hook = decision_hook
        #: planner knob bundle applied to every planner this plane builds
        #: (the what-if auto-tuner's injection point); None = defaults
        self.planner_knobs = planner_knobs
        #: shared sink threaded into every planner this plane builds: each
        #: break-even consult appends its knob-independent inputs and the
        #: decision taken (:func:`repro_torch.core.planner.threshold_value`), so
        #: the campaign engine can re-score alternative knob bundles
        #: against the recorded decision sequence without re-running.
        #: None (the default) records nothing.
        self.planner_trace = planner_trace
        #: observability span tracer (:class:`repro_torch.obs.SpanTracer`) on the
        #: caller's simulated clock: tick spans, watchdog silence/deadline
        #: spans, executor attempt/retry/rollback cycles, per-job fault
        #: episodes. None (the default) keeps the tick hot path allocation-
        #: free — every trace call site is guarded, never stubbed.
        self.tracer = tracer
        self._trace_prev: float | None = None
        #: last ScreenTuning payload mirrored into the event log
        self._last_tuning: dict | None = None
        #: fleet-shared fault-duration survival curves: every job's
        #: resolved diagnoses sharpen every other job's ski-rental
        #: break-even; None keeps the paper's fixed-horizon rule
        self.duration_model = duration_model
        #: accumulated job-seconds watched and fresh incidents seen — their
        #: ratio is the observed mean time between incidents per job, the
        #: healthy window any mitigation can actually buy (caps the
        #: predictive break-even's benefit under fail-slow storms)
        self._watched_s: float = 0.0
        self._fresh_onsets: int = 0
        #: job_id -> latest unresolved Diagnosis (the cross-job dedupe table)
        self._active_diag: dict[str, Diagnosis] = {}
        #: event log in emission order, bounded like the Monitor's comm log
        #: (a fleet ticking forever must not grow memory without bound);
        #: oldest events rotate out of ``events`` / ``diagnoses()`` first
        self.events: deque[ControlEvent] = deque(maxlen=max_events)

    # -- registry of jobs ----------------------------------------------
    def register_job(
        self,
        job_id: str,
        adapter,
        *,
        detector: FalconDetect | None = None,
        registry: StrategyRegistry | None = None,
        overheads: dict | None = None,
        injector=None,
        hardware: Sequence[str] | None = None,
        hosts: Sequence[str] | None = None,
        sample_period: float | None = None,
        work_remaining: Callable[[], float] | None = None,
        now: float = 0.0,
    ) -> JobHandle:
        """Register a job — before the first tick or at any point after.

        A job joining mid-flight is added to the fleet screen as a warming
        stream (:meth:`FleetDetect.add_worker`): established jobs' screening
        state is untouched, and the newcomer starts being screened once it
        has ``warmup`` samples.
        """
        if job_id in self._jobs:
            raise ValueError(f"job {job_id!r} already registered")
        job = JobHandle(
            job_id=job_id,
            adapter=adapter,
            detector=detector or FalconDetect(cluster=adapter),
            registry=registry or default_registry(),
            overheads=dict(overheads or {}),
            injector=injector,
            hardware=tuple(hardware) if hardware is not None else None,
            hosts=tuple(hosts) if hosts is not None else None,
            sample_period=sample_period,
            work_remaining=work_remaining,
        )
        self._jobs[job_id] = job
        if self._fleet is not None:
            job._fleet_col = self._fleet.add_worker()
        self.events.append(Membership(job_id=job_id, time=now, action="join"))
        return job

    def remove_job(self, job_id: str, now: float = 0.0) -> JobHandle:
        """Deregister a job (completion or eviction).

        Its column is sub-sliced out of the fleet screen
        (:meth:`FleetDetect.remove_worker`), its open diagnosis leaves the
        dedupe table, and a leave :class:`Membership` event is logged. The
        returned handle still carries the detector history for post-hoc
        scoring.
        """
        if job_id not in self._jobs:
            raise KeyError(f"job {job_id!r} not registered")
        job = self._jobs.pop(job_id)
        self._active_diag.pop(job_id, None)
        self.watchdog.forget(job_id)
        if self.tracer is not None:
            # A job leaving with an open fault episode censors the span at
            # departure time; its other tracks hold no open spans.
            self.tracer.close_track((job_id, "faults"), now)
        col = job._fleet_col
        if self._fleet is not None and col is not None:
            self._fleet.remove_worker(col)
            for other in self._jobs.values():
                if other._fleet_col is not None and other._fleet_col > col:
                    other._fleet_col -= 1
        self.events.append(Membership(job_id=job_id, time=now, action="leave"))
        return job

    @property
    def jobs(self) -> list[JobHandle]:
        return list(self._jobs.values())

    def job(self, job_id: str) -> JobHandle:
        return self._jobs[job_id]

    # -- state capture (campaign fork/restore contract) -----------------
    #: JobHandle fields a pre-intervention snapshot carries. Everything
    #: else on a handle is either immutable registration data the adopting
    #: caller re-supplies (adapter, registry, hardware, ...) or
    #: intervention state that is still pristine on the shared prefix.
    _JOB_SNAP_FIELDS = (
        "steps", "_fleet_col", "_ticks_active", "_last_sample",
        "_last_seen", "_alarmed",
    )

    def snapshot(self) -> dict:
        """Pre-intervention plane state as private copies.

        Supports the campaign engine's shared-prefix fork
        (``scenarios/engine.py``): valid only while no intervention state
        is live — no active diagnoses, planners, restarts, quarantines or
        executor fail streaks. On that prefix the plane never touches job
        adapters, detectors or injectors, so a fork reproduces the plane
        bit-exactly from fresh instances of those plus the scalars
        captured here (:meth:`adopt_job` + :meth:`restore`).
        """
        for job in self._jobs.values():
            if (
                job.planner is not None
                or job.detector.active_event is not None
                or job._last_restart is not None
                or job._s4_burned
                or job._quarantined
                or job._fail_streaks
            ):
                raise ValueError(
                    f"job {job.job_id!r} carries intervention state; "
                    "snapshot() supports only the pre-divergence prefix"
                )
        if self._active_diag:
            raise ValueError(
                "active diagnoses present; snapshot() supports only the "
                "pre-divergence prefix"
            )
        return {
            "jobs": {
                job_id: {f: getattr(job, f) for f in self._JOB_SNAP_FIELDS}
                for job_id, job in self._jobs.items()
            },
            "fleet": (
                self._fleet.snapshot() if self._fleet is not None else None
            ),
            "watchdog": self.watchdog.snapshot(),
            "watched_s": self._watched_s,
            "fresh_onsets": self._fresh_onsets,
            # _last_tuning mirrors fleet.last_tuning by identity between
            # ticks; restore re-links to the restored fleet's dict so the
            # ``tuning is not self._last_tuning`` emission check holds.
            "last_tuning_mirrored": self._last_tuning is not None,
            "n_events": len(self.events),
        }

    def adopt_job(
        self,
        job_id: str,
        adapter,
        *,
        state: dict,
        detector: FalconDetect | None = None,
        registry: StrategyRegistry | None = None,
        overheads: dict | None = None,
        injector=None,
        hardware: Sequence[str] | None = None,
        hosts: Sequence[str] | None = None,
        sample_period: float | None = None,
        work_remaining: Callable[[], float] | None = None,
    ) -> JobHandle:
        """Re-attach a job mid-flight from snapshot state.

        Like :meth:`register_job` but emits no :class:`Membership` event
        and touches no fleet column bookkeeping — the join already
        happened on the shared leg being forked; ``state`` is this job's
        entry from :meth:`snapshot`'s ``jobs`` map. Adopt jobs in their
        original registration order, then call :meth:`restore`.
        """
        if job_id in self._jobs:
            raise ValueError(f"job {job_id!r} already registered")
        job = JobHandle(
            job_id=job_id,
            adapter=adapter,
            detector=detector or FalconDetect(cluster=adapter),
            registry=registry or default_registry(),
            overheads=dict(overheads or {}),
            injector=injector,
            hardware=tuple(hardware) if hardware is not None else None,
            hosts=tuple(hosts) if hosts is not None else None,
            sample_period=sample_period,
            work_remaining=work_remaining,
        )
        for f, v in state.items():
            setattr(job, f, v)
        self._jobs[job_id] = job
        return job

    def restore(self, snap: dict, *, events: Sequence = ()) -> None:
        """Install a :meth:`snapshot` into this plane (fork completion).

        Every job in the snapshot must already be adopted
        (:meth:`adopt_job`). The fleet screen is rebuilt from this
        plane's own ``fleet_kwargs`` and restored from the snapshot —
        callers forking into different screening semantics (the engine's
        ckpt branch strips adaptive-retune state) adjust the restored
        fleet afterwards. ``events`` becomes the plane's event log
        (the shared leg's prefix, possibly filtered).
        """
        if set(snap["jobs"]) != set(self._jobs):
            raise ValueError(
                "adopted jobs do not match snapshot: "
                f"{sorted(self._jobs)} vs {sorted(snap['jobs'])}"
            )
        for job_id, st in snap["jobs"].items():
            job = self._jobs[job_id]
            for f, v in st.items():
                setattr(job, f, v)
        if snap["fleet"] is not None:
            fleet = FleetDetect(
                n_workers=len(self._jobs), **self._fleet_kwargs
            )
            fleet.restore(snap["fleet"])
            self._fleet = fleet
        else:
            self._fleet = None
        self.watchdog.restore(snap["watchdog"])
        self._watched_s = snap["watched_s"]
        self._fresh_onsets = snap["fresh_onsets"]
        self._last_tuning = (
            self._fleet.last_tuning
            if snap["last_tuning_mirrored"] and self._fleet is not None
            else None
        )
        self._trace_prev = None
        self.events = deque(events, maxlen=self.events.maxlen)

    # -- exact per-job path --------------------------------------------
    def observe(
        self, job_id: str, iter_time: float, now: float
    ) -> list[ControlEvent]:
        """Feed one iteration time through the full per-job pipeline.

        Returns the events emitted for this sample; the caller charges any
        :class:`MitigationResult.overhead` to the job's wall clock. The
        detector and the planning after it are the
        :mod:`repro_torch.obs.runtime` spans ``falcon.detect`` and
        ``falcon.plan``.
        """
        job = self._jobs[job_id]
        out: list[ControlEvent] = [
            Observation(
                job_id=job_id, time=now, iter_time=iter_time, step=job.steps
            )
        ]
        job.steps += 1
        self._watched_s += max(iter_time, 0.0)
        self.watchdog.beat(job_id, now)
        job._last_sample = iter_time
        job._last_seen = now
        job._alarmed = False
        had_active = job.detector.active_event is not None
        with runtime.span("falcon.detect"):
            new_event = job.detector.observe(iter_time, now)
        with runtime.span("falcon.plan"):
            out += self._after_detection(job, new_event, had_active, iter_time, now)
        self.events += out
        return out

    # -- fleet screening path ------------------------------------------
    def tick(
        self, times: Mapping[str, float] | Sequence[float] | np.ndarray,
        now: float,
    ) -> list[ControlEvent]:
        """Advance every registered job one tick through the fleet screen.

        ``times`` is one iteration time per job — a mapping keyed by job id,
        or a sequence in registration order. A mapping may *omit* jobs: a
        stalled job's current iteration never completes, so its monitor has
        nothing to report. Silent jobs get no Observation; their fleet-
        screen column is imputed flat (the last delivered sample — exactly
        the shape BOCD cannot flag) and the heartbeat watchdog takes over:
        once the silence exceeds the stream's jitter-calibrated deadline a
        :class:`WatchdogAlarm` fires and a synthesized change-point runs
        the normal pinpoint path, yielding a hang-flagged Diagnosis and a
        hang mitigation ladder.
        """
        jobs = list(self._jobs.values())
        tr = self.tracer
        if tr is not None:
            # The tick span covers the sampling interval it processes:
            # [previous tick, now] on the fleet track.
            prev = self._trace_prev
            tr.begin(
                ("fleet", "controlplane"), "tick",
                prev if prev is not None and prev < now else now,
            )
            self._trace_prev = now
        if self._fleet is None:
            self._fleet = FleetDetect(n_workers=len(jobs), **self._fleet_kwargs)
            for col, job in enumerate(jobs):
                job._fleet_col = col
        by_col = {j._fleet_col: j for j in jobs}
        if isinstance(times, Mapping):
            per_job = {
                j.job_id: float(times[j.job_id])
                for j in jobs if j.job_id in times
            }
        else:
            seq = np.asarray(times, dtype=np.float64)
            if seq.shape != (len(jobs),):
                raise ValueError(f"expected {len(jobs)} times, got {seq.shape}")
            per_job = {j.job_id: float(seq[i]) for i, j in enumerate(jobs)}
        for job in jobs:
            if job.job_id in per_job:
                self.watchdog.beat(job.job_id, now)
        vec = np.empty(len(jobs), dtype=np.float64)
        for job in jobs:
            if job.job_id in per_job:
                vec[job._fleet_col] = per_job[job.job_id]
            else:
                # Flat continuation of the last delivered sample keeps the
                # lockstep screen's shape; it carries no change for BOCD to
                # see, which is the point — silence is the watchdog's job.
                vec[job._fleet_col] = (
                    job._last_sample if job._last_sample > 0 else 1.0
                )
        flags = {f.worker: f for f in self._fleet.tick(vec)}

        out: list[ControlEvent] = []
        for w in sorted(by_col):
            job = by_col[w]
            try:
                if job.job_id not in per_job:
                    out += self._silent_job(job, now)
                    continue
                iter_time = float(vec[w])
                out.append(
                    Observation(
                        job_id=job.job_id, time=now, iter_time=iter_time,
                        step=job.steps,
                    )
                )
                job.steps += 1
                if tr is not None and (job.steps - 1) % tr.counter_stride == 0:
                    tr.counter(
                        (job.job_id, "iter_time"), "iter_time", now, iter_time
                    )
                job._last_sample = iter_time
                job._last_seen = now
                job._alarmed = False
                self._watched_s += (
                    job.sample_period
                    if job.sample_period is not None
                    else max(iter_time, 0.0)
                )
                had_active = job.detector.active_event is not None
                new_event: FailSlowEvent | None = None
                deduped_from: str | None = None
                flag = flags.get(w)
                if flag is not None:
                    cp = flag.change_point
                    out.append(
                        Flag(job_id=job.job_id, time=now, change_point=cp)
                    )
                    if tr is not None:
                        tr.instant(
                            (job.job_id, "detector"), "flag", now,
                            args={
                                "probability": cp.probability,
                                "mean_before": cp.mean_before,
                                "mean_after": cp.mean_after,
                            },
                        )
                    source = None
                    if (
                        cp.relative_change > 0
                        and job.detector.active_event is None
                    ):
                        source = self._dedupe_source(job)
                    if source is not None:
                        event = self._adopt(job, source, cp, now)
                        if event is not None:
                            new_event, deduped_from = event, source.job_id
                    if new_event is None and deduped_from is None:
                        new_event = job.detector.ingest_changepoint(cp, now)
                elif job.detector.active_event is not None:
                    # No flag while an event is active: mitigation may have
                    # flattened the signal — periodic O(1) re-validation is
                    # the only way to see the fault's relief (or a compound
                    # pile-on).
                    job._ticks_active += 1
                    if job._ticks_active % job.detector.revalidate_every == 0:
                        new_event = job.detector.revalidate(
                            now, iter_time=iter_time, index=job.steps - 1
                        )
                out += self._after_detection(
                    job, new_event, had_active, iter_time, now,
                    deduped_from=deduped_from,
                )
            except Exception as exc:  # noqa: BLE001 — graceful degradation
                # One bad job (adapter raising mid-pinpoint, a broken
                # detector) must not stall the fleet: surface the failure
                # as a typed event and keep ticking the other jobs.
                out.append(
                    MitigationResult(
                        job_id=job.job_id, time=now, strategy=None,
                        applied=False, kind="error", status="failed",
                        detail={"error": f"{type(exc).__name__}: {exc}"},
                    )
                )
        tuning = getattr(self._fleet, "last_tuning", None)
        if tuning is not None and tuning is not self._last_tuning:
            # The adaptive screen chose new knobs at the END of this tick
            # (FleetDetect retunes after collecting the tick's flags), so
            # the event is appended after them: every Flag *after* a
            # ScreenTuning entry was screened under its parameters.
            self._last_tuning = tuning
            out.append(ScreenTuning(
                job_id="", time=now,
                hazard=tuning["hazard"],
                max_hypotheses=tuning["max_hypotheses"],
                change_rate=tuning["change_rate"],
                flags=tuning["flags"],
                worker_ticks=tuning["worker_ticks"],
            ))
        if tr is not None:
            tr.end(
                ("fleet", "controlplane"), now,
                args={"jobs": len(jobs), "events": len(out)},
            )
        self.events += out
        return out

    # -- hang watchdog path --------------------------------------------
    def _silent_job(self, job: JobHandle, now: float) -> list[ControlEvent]:
        """One tick of a registered job whose stream produced no sample.

        While the watchdog deadline has not yet expired, only the planner
        is advanced (an already-diagnosed event keeps accumulating impact
        at the stalled rate). On expiry, a :class:`WatchdogAlarm` fires
        once and a synthesized change-point — last delivered sample as the
        before-mean, the adapter's current (stalled) iteration time as the
        after-mean — is routed through the job's own detector, so the hang
        gets the same profiling + validation pinpoint a slowdown would,
        and the resulting event is flagged ``hang`` for the abort ladder.
        """
        out: list[ControlEvent] = []
        if job.sample_period is not None:
            self._watched_s += job.sample_period
        # The stalled iteration time: what the job's clock is stuck paying.
        stalled_t = job._last_sample if job._last_sample > 0 else 1.0
        it = getattr(job.adapter, "iteration_time", None)
        if callable(it):
            try:
                stalled_t = max(float(it()), stalled_t)
            except Exception:  # noqa: BLE001 — adapter may itself be wedged
                pass
        had_active = job.detector.active_event is not None
        new_event: FailSlowEvent | None = None
        active = job.detector.active_event
        already_hang = active is not None and getattr(active, "hang", False)
        if (
            not already_hang
            and not job._alarmed
            and self.watchdog.expired(job.job_id, now)
        ):
            job._alarmed = True
            deadline = self.watchdog.deadline(job.job_id) or 0.0
            silence = self.watchdog.silence(job.job_id, now)
            out.append(WatchdogAlarm(
                job_id=job.job_id, time=now,
                last_seen=job._last_seen if job._last_seen is not None else 0.0,
                deadline_s=deadline,
                silence_s=silence,
            ))
            tr = self.tracer
            if tr is not None:
                # The silence window [last heartbeat, alarm] with the
                # calibrated deadline budget nested inside it: how far past
                # the budget the stream ran before the alarm fired.
                last = job._last_seen if job._last_seen is not None else 0.0
                track = (job.job_id, "watchdog")
                tr.span(
                    track, "silence", last, now, args={"silence_s": silence}
                )
                tr.span(
                    track, "deadline", last, last + deadline,
                    args={"deadline_s": deadline},
                )
                tr.instant(track, "alarm", now)
            base = job._last_sample if job._last_sample > 0 else 1.0
            cp = ChangePoint(
                index=max(job.steps - 1, 0), probability=1.0,
                mean_before=base, mean_after=max(stalled_t, 2.0 * base),
            )
            new_event = job.detector.ingest_changepoint(cp, now)
            if new_event is not None:
                new_event.hang = True
        out += self._after_detection(job, new_event, had_active, stalled_t, now)
        return out

    # -- shared post-detection pipeline --------------------------------
    def _after_detection(
        self,
        job: JobHandle,
        new_event: FailSlowEvent | None,
        had_active: bool,
        iter_time: float,
        now: float,
        deduped_from: str | None = None,
    ) -> list[ControlEvent]:
        out: list[ControlEvent] = []
        if new_event is not None:
            # Every onset — fresh, compound pile-on, or adopted from a
            # co-located job — is one more fault arrival hitting a job:
            # together with the job-seconds watched it yields the observed
            # incident inter-arrival time (see :meth:`incident_gap`).
            self._fresh_onsets += 1
            if (
                job._last_restart is not None
                and not job._s4_burned
                and now - job._last_restart
                <= job.effective_overheads().get(Strategy.CKPT_AND_RESTART, 0.0)
            ):
                # Fool me once: the last restart's healthy window did not
                # even pay back its own overhead before the next incident
                # landed — the fault environment, not any one fault, is
                # the bottleneck, and further restarts cannot win.
                job._s4_burned = True
            diag = Diagnosis(
                job_id=job.job_id,
                time=now,
                event=new_event,
                components_global=self._globalize(job, new_event.components),
                deduped_from=deduped_from,
                breakdown=self._breakdown(job),
            )
            out.append(diag)
            self._active_diag[job.job_id] = diag
            tr = self.tracer
            if tr is not None:
                # Fault episode span: opened at diagnosis, closed at
                # relief (or the horizon). A compound pile-on opens a
                # nested span inside the still-active episode.
                args: dict = {
                    "cause": new_event.root_cause.value,
                    "components": list(new_event.components),
                }
                if getattr(new_event, "hang", False):
                    args["hang"] = True
                if deduped_from is not None:
                    args["deduped_from"] = deduped_from
                if diag.breakdown is not None:
                    args.update(diag.breakdown.summary())
                tr.begin(
                    (job.job_id, "faults"),
                    f"fault:{new_event.root_cause.value}", now, args=args,
                )
            exclude: set[StrategyKey] = set()
            if job._s4_burned:
                exclude.add(Strategy.CKPT_AND_RESTART)
            # Quarantined rungs (executor failures) are withheld for events
            # of the cause they kept failing on, so the ladder escalates
            # past them instead of retrying into the same wall.
            exclude |= {
                s for (c, s) in job._quarantined
                if c is new_event.root_cause
            }
            job.planner = job.registry.make_planner(
                new_event,
                job.overheads,
                estimator=self.duration_model,
                work_remaining=job.work_remaining,
                incident_gap=self.incident_gap,
                exclude=exclude or None,
                knobs=self.planner_knobs,
                trace=self.planner_trace,
            )
        active = job.detector.active_event
        if active is None:
            if had_active:
                if self.tracer is not None:
                    self.tracer.close_track((job.job_id, "faults"), now)
                if self._hook_allow_relief(job.job_id, now):
                    out += self._relief(job, now)
                else:
                    out.append(
                        MitigationResult(
                            job_id=job.job_id, time=now, strategy=None,
                            applied=False, kind="suppressed", status="ok",
                            detail={"relief": True},
                        )
                    )
            job.planner = None
            self._active_diag.pop(job.job_id, None)
        elif job.planner is not None:
            # On a sampling clock, one sample stands for sample_period /
            # iter_time iterations — the ski-rental impact integral counts
            # iterations so its break-even stays in wall-clock units.
            weight = 1.0
            if job.sample_period is not None and iter_time > 0:
                weight = job.sample_period / iter_time
            strategy = job.planner.update(
                slow_iters=weight, current_time=iter_time
            )
            if strategy is not None:
                if self._hook_allow(job.job_id, strategy, now):
                    out.append(
                        MitigationAction(
                            job_id=job.job_id, time=now, strategy=strategy,
                            event=active,
                        )
                    )
                    out += self._execute(job, strategy, active, now)
                else:
                    # Counterfactually suppressed: the decision is recorded
                    # (the ladder still advances past this rung) but nothing
                    # is dispatched — no adapter mutation, no overhead, no
                    # executor-fault draw.
                    out.append(
                        MitigationResult(
                            job_id=job.job_id, time=now, strategy=strategy,
                            applied=False, kind="suppressed", status="ok",
                            detail={"event_start": active.start_time},
                        )
                    )
        if active is not None:
            for forced in self._hook_forced(job.job_id, now):
                out.append(
                    MitigationAction(
                        job_id=job.job_id, time=now, strategy=forced,
                        event=active,
                    )
                )
                out += self._execute(job, forced, active, now)
        return out

    def _breakdown(self, job: JobHandle):
        """Per-collective timing decomposition of the job's iteration, when
        the adapter can produce one (:meth:`TrainingSimulator.collective_breakdown`).
        Returns None for adapters without the capability (trace replay,
        hardware) or when the adapter is wedged — diagnosis must never fail
        because observability did."""
        fn = getattr(job.adapter, "collective_breakdown", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 — observability is best-effort
            return None

    # -- counterfactual decision intercept -------------------------------
    def _hook_allow(self, job_id: str, strategy: StrategyKey, now: float) -> bool:
        fn = getattr(self.decision_hook, "allow", None)
        return True if fn is None else bool(fn(job_id, strategy, now))

    def _hook_allow_relief(self, job_id: str, now: float) -> bool:
        fn = getattr(self.decision_hook, "allow_relief", None)
        return True if fn is None else bool(fn(job_id, now))

    def _hook_forced(self, job_id: str, now: float) -> list[StrategyKey]:
        fn = getattr(self.decision_hook, "forced", None)
        return [] if fn is None else list(fn(job_id, now))

    # -- fault-tolerant executor ---------------------------------------
    def _snapshot(self, job: JobHandle) -> dict:
        """Pre-action state: adapter snapshot (when it offers one) plus the
        injector's schedule (strategies mutate it — S4/abort clear
        episodes, and a failed attempt must put them back)."""
        snap: dict = {}
        if hasattr(job.adapter, "snapshot"):
            snap["adapter"] = job.adapter.snapshot()
        if job.injector is not None and hasattr(job.injector, "injections"):
            snap["injections"] = list(job.injector.injections)
        return snap

    def _rollback(self, job: JobHandle, snap: dict) -> bool:
        """Restore a :meth:`_snapshot`. True when state was restorable."""
        rolled = False
        if "adapter" in snap and hasattr(job.adapter, "restore"):
            job.adapter.restore(snap["adapter"])
            rolled = True
        if "injections" in snap:
            if list(job.injector.injections) != snap["injections"]:
                # Wholesale reassignment bumps the injector epoch, so
                # schedule cursors re-apply against the restored state.
                job.injector.injections = snap["injections"]
            rolled = True
        return rolled

    def _execute(
        self, job: JobHandle, strategy: StrategyKey, event, now: float
    ) -> list[ControlEvent]:
        """Fault-tolerant strategy dispatch: snapshot → apply → on failure
        roll back, back off, retry; emit one typed :class:`MitigationResult`
        per attempt (status ``ok`` / ``failed`` / ``timed_out``) plus a
        terminal ``rolled_back`` result when retries are exhausted. See
        :class:`ExecutorPolicy` and docs/control_plane.md.
        """
        pol = self.executor_policy
        max_attempts = max(pol.max_attempts, 1)
        overhead = (
            job.planner.overheads.get(strategy, 0.0)
            if job.planner is not None
            else job.effective_overheads().get(strategy, 0.0)
        )
        ctx = MitigationContext(
            adapter=job.adapter, event=event, now=now,
            job_id=job.job_id, injector=job.injector,
        )
        cause = getattr(event, "root_cause", None)
        streak_key = (cause, strategy)
        out: list[ControlEvent] = []
        rolled = False
        quarantined = False
        tr = self.tracer
        track = (job.job_id, "executor")
        label = strategy_label(strategy)
        # The executor's simulated-time cursor: attempt N's span starts
        # after the charges (timeouts, backoffs) of attempts 1..N-1, so the
        # trace shows the retry cycle laid out the way the job's wall clock
        # actually paid for it.
        t_cursor = now
        if tr is not None:
            tr.begin(track, f"dispatch:{label}", now)
        for attempt in range(1, max_attempts + 1):
            snap = self._snapshot(job)
            failure: tuple[str, dict] | None = None
            outcome = None
            try:
                outcome = job.registry.dispatch(strategy, ctx)
            except Exception as exc:  # noqa: BLE001 — typed failure capture
                failure = ("failed", {"error": f"{type(exc).__name__}: {exc}"})
            if failure is None and self.executor_faults is not None:
                verdict = self.executor_faults(
                    job.job_id, strategy, attempt, now
                )
                if verdict in ("fail", "timeout"):
                    failure = (
                        "failed" if verdict == "fail" else "timed_out",
                        {"injected": verdict},
                    )
            if failure is None:
                job._fail_streaks.pop(streak_key, None)
                if strategy is Strategy.CKPT_AND_RESTART and outcome.applied:
                    job._last_restart = now
                out.append(
                    MitigationResult(
                        job_id=job.job_id, time=now, strategy=strategy,
                        applied=outcome.applied, overhead=overhead,
                        detail=outcome.detail, attempt=attempt,
                    )
                )
                if tr is not None:
                    tr.span(
                        track, f"attempt {attempt}", t_cursor,
                        t_cursor + overhead,
                        args={"status": "ok", "applied": outcome.applied},
                    )
                    tr.end(
                        track, t_cursor + overhead,
                        args={"status": "ok", "attempts": attempt},
                    )
                return out
            status, detail = failure
            rolled = self._rollback(job, snap)
            streak = job._fail_streaks.get(streak_key, 0) + 1
            job._fail_streaks[streak_key] = streak
            if streak >= pol.quarantine_after and not quarantined:
                quarantined = True
                job._quarantined.add(streak_key)
            will_retry = attempt < max_attempts and not quarantined
            charge = pol.timeout_s if status == "timed_out" else 0.0
            if will_retry:
                charge += pol.backoff_base_s * (2.0 ** (attempt - 1))
            detail = dict(detail)
            detail["rolled_back"] = rolled
            if quarantined:
                detail["quarantined"] = True
            out.append(
                MitigationResult(
                    job_id=job.job_id, time=now, strategy=strategy,
                    applied=False, overhead=charge, detail=detail,
                    status=status, attempt=attempt,
                )
            )
            if tr is not None:
                tr.span(
                    track, f"attempt {attempt}", t_cursor, t_cursor + charge,
                    args={"status": status},
                )
                tr.instant(
                    track, "rollback", t_cursor + charge,
                    args={"rolled_back": rolled},
                )
                if quarantined:
                    tr.instant(track, "quarantine", t_cursor + charge)
            t_cursor += charge
            if not will_retry:
                break
        # Retries exhausted (or quarantine cut them short): the terminal
        # record — job state is back at the pre-action snapshot.
        out.append(
            MitigationResult(
                job_id=job.job_id, time=now, strategy=strategy,
                applied=False, overhead=0.0, status="rolled_back",
                attempt=attempt,
                detail={
                    "exhausted": True, "rolled_back": rolled,
                    **({"quarantined": True} if quarantined else {}),
                },
            )
        )
        if tr is not None:
            tr.end(
                track, t_cursor,
                args={"status": "rolled_back", "attempts": attempt},
            )
        return out

    def _relief(self, job: JobHandle, now: float) -> list[ControlEvent]:
        """The active event resolved: emit the closing diagnosis and let
        every registered strategy undo residual skew (S2 re-balances the
        micro-batch split for the recovered cluster)."""
        out: list[ControlEvent] = []
        closed = job.detector.history[-1] if job.detector.history else None
        if closed is not None and self.duration_model is not None:
            # Feed the survival curves. A fault our own restart (or
            # collective abort) cleared would have lasted longer — record
            # it right-censored so mitigation does not bias the curve
            # short. A hang is always censored: its natural duration is
            # unbounded, and whatever ended it, the observed span is a
            # lower bound, not a draw from the duration distribution.
            censored = bool(getattr(closed, "hang", False)) or (
                job.planner is not None
                and any(
                    k is Strategy.CKPT_AND_RESTART or k == "ABORT_REFORM"
                    for k in job.planner.applied
                )
            )
            self.duration_model.observe(
                closed.root_cause,
                closed.duration(now),
                censored=censored,
            )
        if closed is not None:
            out.append(
                Diagnosis(
                    job_id=job.job_id,
                    time=now,
                    event=closed,
                    components_global=self._globalize(job, closed.components),
                    resolved=True,
                )
            )
        ctx = MitigationContext(
            adapter=job.adapter, event=closed, now=now, job_id=job.job_id,
            injector=job.injector,
        )
        for key, outcome in job.registry.relieve(ctx):
            out.append(
                MitigationResult(
                    job_id=job.job_id, time=now, strategy=key,
                    applied=outcome.applied, kind="relief",
                    detail=outcome.detail,
                    status="failed" if "error" in outcome.detail else "ok",
                )
            )
        return out

    # -- cross-job hardware dedupe --------------------------------------
    def _globalize(
        self, job: JobHandle, components: Sequence[str]
    ) -> tuple[str, ...]:
        """Translate job-local component ids through the hardware/host maps.

        Device-scoped components (``gpu:``/``link:``) go through the
        hardware map; node-scoped ones (``node:`` host faults, ``nic:``
        ports) through the hosts map, so co-located jobs with disjoint
        device sets still share a dedupe identity for host-level faults.
        """
        hw = job.hardware
        hosts = job.hosts
        out = []
        for comp in components:
            kind, _, ident = comp.partition(":")
            try:
                if kind == "gpu" and hw is not None:
                    out.append(f"gpu:{hw[int(ident)]}")
                elif kind == "link" and hw is not None:
                    a, b = (int(x) for x in ident.split("-"))
                    lo, hi = sorted((hw[a], hw[b]))
                    out.append(f"link:{lo}|{hi}")
                elif kind in ("node", "nic") and hosts is not None:
                    out.append(f"{kind}:{hosts[int(ident)]}")
            except (ValueError, IndexError):
                continue
        return tuple(out)

    def _dedupe_source(self, job: JobHandle) -> Diagnosis | None:
        """An unresolved diagnosis from another job touching this job's
        hardware, if any — its pinpoint can be reused instead of re-running
        profiling + validation."""
        if job.hardware is None and job.hosts is None:
            return None
        for other_id, diag in self._active_diag.items():
            if other_id == job.job_id or not diag.components_global:
                continue
            if self._localize(job, diag.components_global):
                return diag
        return None

    def _localize(
        self, job: JobHandle, components_global: Sequence[str]
    ) -> list[str]:
        """Global component ids -> this job's local ids (unmapped dropped)."""
        inverse = job._hw_inverse
        hosts_inv = job._host_inverse
        out = []
        for comp in components_global:
            kind, _, ident = comp.partition(":")
            if kind == "gpu" and inverse is not None and ident in inverse:
                out.append(f"gpu:{inverse[ident]}")
            elif kind == "link" and inverse is not None:
                a, _, b = ident.partition("|")
                if a in inverse and b in inverse:
                    lo, hi = sorted((inverse[a], inverse[b]))
                    out.append(f"link:{lo}-{hi}")
            elif kind in ("node", "nic") and hosts_inv is not None:
                if ident in hosts_inv:
                    out.append(f"{kind}:{hosts_inv[ident]}")
        return out

    def _adopt(
        self, job: JobHandle, source: Diagnosis, cp, now: float
    ) -> FailSlowEvent | None:
        """Build this job's event from another job's diagnosis: shared root
        cause and components (translated to local ranks), this job's own
        timing from its verified change-point.

        Trust but verify: before adopting, the translated components are
        re-measured through *this* job's adapter (the detector's O(1)
        component validation). A co-located job can flag for an unrelated
        reason — e.g. its own GPU fault while a neighbour's NIC is congested
        — and blindly inheriting the neighbour's diagnosis would both
        mislabel this job's fault and leave it unpinpointed. If the shared
        components measure healthy here, the dedupe is rejected and the job
        runs its own profiling + validation.
        """
        local = self._localize(job, source.components_global)
        if not local:
            return None
        probe = FailSlowEvent(
            start_time=now, root_cause=source.event.root_cause,
            components=local,
        )
        if job.detector.components_recovered(probe):
            return None
        severity = 0.0
        if cp.mean_after > 0:
            severity = max(0.0, 1.0 - cp.mean_before / cp.mean_after)
        event = FailSlowEvent(
            start_time=now,
            root_cause=source.event.root_cause,
            components=local,
            t_healthy=cp.mean_before,
            t_slow=cp.mean_after,
            severity=severity,
        )
        return job.detector.adopt_event(event, now)

    # -- introspection ---------------------------------------------------
    def incident_gap(self) -> float:
        """Observed mean wall-clock gap between fresh incidents per job.

        Derived from the plane's own event stream (job-seconds watched over
        fresh onset diagnoses). This is the healthy window a successful
        mitigation can expect to buy before the next fault lands — under a
        fail-slow storm it, not the current fault's remaining duration,
        bounds what an expensive action (S4) is worth. The +1 is Laplace
        smoothing for the systematic undercount early in a fleet's life:
        detection warmup and latency mean arrivals are always seen late.
        """
        return self._watched_s / (self._fresh_onsets + 1)

    def diagnoses(self, job_id: str | None = None) -> list[Diagnosis]:
        return [
            e for e in self.events
            if isinstance(e, Diagnosis)
            and (job_id is None or e.job_id == job_id)
        ]
