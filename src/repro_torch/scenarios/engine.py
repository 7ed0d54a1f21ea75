"""Shared-prefix campaign execution — snapshot-forked mode tree + memoized
variant scoring.

:func:`~repro_torch.scenarios.campaign.run_campaign` executes the four campaign
modes independently, yet ``faults`` / ``ckpt`` / ``falcon`` are
bit-identical until the control plane first *intervenes*: before the first
non-observation event the plane never touches a simulator, an injector or
a jitter stream, so three of the four runs spend most of their ticks
recomputing the same timeline. :class:`CampaignEngine` runs that timeline
once and forks at the divergence point:

* the **faults** leg runs fresh and is *recorded*: per-tick samples, each
  job's cumulative progress, stall count and jitter-draw count, joins and
  finishes. Every plane-mode prefix rides this recording.
* a **shared plane leg** (falcon screening semantics, fused fleet screen)
  is driven by the recorded samples with lazily-materialized job adapters,
  taking a rolling :meth:`ControlPlane.snapshot` each tick. It stops at
  the first event outside {Observation, Membership, ScreenTuning} — the
  divergence tick ``D`` — and also marks ``R``, the first adaptive retune
  that *changed* the screening parameters (the tick falcon's and ckpt's
  screens stop being interchangeable).
* the **falcon** branch forks from the snapshot at ``D-1`` and replays
  from ``D`` at full fidelity. The **ckpt** branch forks at ``min(R, D)-1``
  (ScreenTuning events stripped, the retune mirror scrubbed, adaptation
  off) and — when ``R < D`` — continues on its own recorded leg until its
  own divergence.
* **per-job divergence tracking**: inside a branch, a job the plane never
  intervenes on stays *virtual* — its samples, progress and stalls are
  served from the recording, and its simulator / injector / rng are
  materialized only on first touch (a flag ingest, a silent-stall read, a
  mitigation dispatch), reconstructed bit-exactly from the placement, the
  schedule and a fast-forwarded jitter stream. :attr:`RunResult.touched_jobs`
  reports which jobs actually left the recording.
* **memoized variant scoring**: identical ``(mode, knobs)`` requests
  return the cached run outright, and a new knob bundle is first re-scored
  against every cached run's recorded break-even consult trace
  (:func:`repro_torch.core.planner.threshold_value`) — if it reproduces the same
  decision sequence, the cached leg *is* its run.

Everything the engine returns is byte-identical to fresh
:func:`run_campaign` execution, across presets and seeds.
Callers needing tracers, backend overrides, episode drops or per-job
subsets fall back to ``run_campaign`` (see
:func:`repro_torch.scenarios.scoring.run_and_score`).

This is the twin of the reference's ``scenarios/engine.py``; its account is
docs/scenarios.md. The engine takes ``device`` (None = the card) for every
simulator and fleet screen it builds. Its legs ask for the fused fleet
screen, which only the numpy ``batched`` backend has; the default (``auto``)
screen of the port is the ``cuda`` kernel on the card and the plain
``torch`` step on the CPU, which keep one frontier per cohort and snapshot
it in their ``"slots"`` layout. On the card each rolling
:meth:`ControlPlane.snapshot` therefore copies every cohort's slot state to
the host (restore is bit-exact).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.cluster.injector import FailSlowInjector
from repro_torch.controlplane import ControlPlane, MitigationResult
from repro_torch.controlplane.events import Observation, ScreenTuning
from repro_torch.core.duration import DurationModel
from repro_torch.core.planner import PlannerKnobs, threshold_value
from repro_torch.scenarios.campaign import (
    MODES,
    CampaignSpec,
    JobOutcome,
    RunResult,
    _changed_episodes,
    _registry_for,
    run_campaign,
)
from repro_torch.scenarios.faults import ExecutorFaultModel


class _JobRec:
    """One job's recorded fault-mode trajectory, indexed by campaign tick."""

    __slots__ = ("join_tick", "end_tick", "iters", "stalled", "draws")

    def __init__(self, join_tick: int) -> None:
        self.join_tick = join_tick
        self.end_tick: int | None = None
        #: iters_done after each tick's work phase, tick ``join_tick + i``
        self.iters: list[float] = []
        #: stalled_ticks after each tick's sample phase
        self.stalled: list[int] = []
        #: cumulative jitter draws consumed after each tick's sample phase
        self.draws: list[int] = []

    def iters_at(self, tick: int) -> float:
        i = tick - self.join_tick
        return self.iters[i] if i >= 0 else 0.0

    def stalled_at(self, tick: int) -> int:
        i = tick - self.join_tick
        return self.stalled[i] if i >= 0 else 0

    def draws_at(self, tick: int) -> int:
        i = tick - self.join_tick
        return self.draws[i] if i >= 0 else 0


class _Recording:
    """The faults leg's full trajectory — the shared prefix every plane
    mode rides and every virtual job replays."""

    __slots__ = ("samples", "jobs", "ticks_run")

    def __init__(self) -> None:
        #: per tick, the samples dict exactly as the runner built it
        self.samples: list[dict[str, float]] = []
        self.jobs: dict[str, _JobRec] = {}
        self.ticks_run: int = 0


class _Proxy:
    """Materialize-on-first-touch stand-in for a virtual job's simulator
    or injector. Any public attribute access — read or write — first
    reconstructs the real object at the engine's current tick and then
    delegates to it (writes matter: strategies assign
    ``injector.injections`` to clear mitigated episodes, and that property
    setter must run on the real injector). The accesses the control plane
    makes — silent-stall reads, snapshot probes, strategy dispatch — are
    exactly the moments a job stops being untouched."""

    __slots__ = ("_holder", "_kind")

    def __init__(self, holder: "_JobHolder", kind: str) -> None:
        object.__setattr__(self, "_holder", holder)
        object.__setattr__(self, "_kind", kind)

    def _target(self):
        holder = self._holder
        holder.materialize()
        return holder.sim if self._kind == "sim" else holder.injector

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._target(), name)

    def __setattr__(self, name: str, value) -> None:
        setattr(self._target(), name, value)


class _JobHolder:
    """Lazy reconstruction context for one virtual job.

    Materialization is bit-exact: a fresh simulator from the placement, a
    fresh injector fully applied at the current tick's start (the
    injector's full-apply equals its incremental applies — the PR-6
    snapshot contract), and the job's jitter stream fast-forwarded by the
    recorded draw count (one batched draw is bitwise the same stream state
    as the per-tick scalar draws).
    """

    __slots__ = ("engine", "placed", "st", "sim", "injector", "sim_proxy",
                 "injector_proxy")

    def __init__(self, engine: "CampaignEngine", placed, st: dict | None = None):
        self.engine = engine
        self.placed = placed
        self.st = st
        self.sim = None
        self.injector = None
        self.sim_proxy = _Proxy(self, "sim")
        self.injector_proxy = _Proxy(self, "injector")

    def materialize(self) -> None:
        if self.sim is not None:
            return
        engine, placed = self.engine, self.placed
        spec = engine.spec
        tick = engine.cur_tick
        dt = spec.preset.tick_seconds
        sim = placed.make_sim(engine.device)
        injector = FailSlowInjector(list(placed.local_schedule))
        injector.apply(sim.state, tick * dt)
        rng = np.random.default_rng([spec.seed, 7, int(placed.job_id[1:])])
        k = engine.rec.jobs[placed.job_id].draws_at(tick)
        if k:
            rng.normal(1.0, spec.preset.jitter, size=k)
        self.sim = sim
        self.injector = injector
        if self.st is not None:
            self.st["sim"] = sim
            self.st["injector"] = injector
            self.st["rng"] = rng
            self.st["epoch"] = injector.epoch
            self.st["virtual"] = False


@dataclass
class _Fork:
    """A branch's starting point: the first tick to replay at full
    fidelity, the plane snapshot at the end of the tick before it, and the
    event-log prefix that snapshot covers (``events is None`` = resolve
    from the leg's final log by the snapshot's event count)."""

    tick: int
    blob: dict
    events: list | None


class CampaignEngine:
    """Shared-prefix executor for one campaign spec (see module docstring).

    ``engine.run(mode)`` is byte-identical to ``run_campaign(spec, mode)``
    for every mode, knob bundle and decision hook; repeated and
    decision-equivalent requests are served from the mode tree instead of
    re-executed.
    """

    def __init__(self, spec: CampaignSpec, device=None) -> None:
        self.spec = spec
        #: torch device of every simulator and fleet screen the legs build
        #: (None = the card, raising when there is none)
        self.device = device
        #: current campaign tick of whichever leg is executing — the
        #: reconstruction clock for lazy job materialization
        self.cur_tick = 0
        self.rec: _Recording | None = None
        self._base: dict[str, RunResult] | None = None
        self._shared: dict | None = None
        self._ckpt_plan: tuple | None = None
        self._memo: dict[tuple, RunResult] = {}
        self._traces: dict[str, list[dict]] = {}
        #: reuse ledger: how the mode tree served requests
        self.stats = {
            "memo_hits": 0, "trace_hits": 0,
            "forked_runs": 0, "reused_runs": 0, "fresh_runs": 0,
        }

    # -- public API ------------------------------------------------------
    def run(
        self,
        mode: str,
        *,
        planner_knobs: PlannerKnobs | None = None,
        decision_hook: object | None = None,
    ) -> RunResult:
        """The campaign's run under ``mode`` — bit-identical to
        ``run_campaign(spec, mode, planner_knobs=..., decision_hook=...)``.

        Knobs and hooks only act through the planner and the dispatch
        gate, both strictly after the divergence point, so every variant
        shares the same fork. Hook runs are never memoized (hooks are
        stateful); knob runs are memoized by value and by decision trace.
        """
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self._ensure_base()
        if mode in ("healthy", "faults"):
            # Knobs and hooks are no-ops without a control plane.
            return self._base[mode]
        if decision_hook is not None:
            return self._branch(
                mode, planner_knobs=planner_knobs, decision_hook=decision_hook
            )
        knobs = planner_knobs if planner_knobs is not None else PlannerKnobs()
        key = (mode, knobs)
        hit = self._memo.get(key)
        if hit is not None:
            self.stats["memo_hits"] += 1
            return hit
        res = self._probe_traces(mode, knobs)
        if res is None:
            trace: list = []
            res = self._branch(
                mode, planner_knobs=planner_knobs, planner_trace=trace
            )
            self._traces.setdefault(mode, []).append(
                {"knobs": knobs, "trace": trace, "result": res}
            )
        self._memo[key] = res
        return res

    # -- base legs -------------------------------------------------------
    def _ensure_base(self) -> None:
        if self._base is not None:
            return
        self._base = {
            "healthy": run_campaign(self.spec, "healthy", device=self.device)
        }
        faults, rec = self._full_leg("faults", record=True)
        self.rec = rec
        self._base["faults"] = faults
        self._shared = self._recorded_leg(
            fleet_kwargs=self._fleet_kwargs("falcon"), watch_retune=True
        )

    def _fleet_kwargs(self, mode: str) -> dict:
        # The engine's legs always run the fused (single-launch) fleet
        # screen — bit-equivalent to the per-cohort default and cheaper
        # per tick, and forks restore into the same layout.
        kw: dict = {"fused": True, "device": self.device}
        if mode == "falcon" and self.spec.preset.adapt_every:
            kw["adapt_every"] = self.spec.preset.adapt_every
        return kw

    def _join_order(self):
        return sorted(
            self.spec.jobs, key=lambda j: (j.join_tick, int(j.job_id[1:]))
        )

    # -- mode plans ------------------------------------------------------
    def _falcon_plan(self) -> tuple:
        sh = self._shared
        if sh["status"] == "completed":
            return ("done", sh["events"])
        return ("fork", sh["fork"])

    def _ckpt(self) -> tuple:
        """The ckpt branch plan, computed lazily on first ckpt run.

        Until the first value-changing retune ``R`` the falcon-semantics
        shared leg and a fresh ckpt plane are interchangeable (a neutral
        retune rewrites identical values and ckpt never consults the
        adaptive counters), so ckpt forks at ``min(R, D) - 1`` with the
        ScreenTuning events stripped and the retune mirror scrubbed. When
        ``R < D`` the fork continues on its own recorded ckpt-config leg
        until ckpt's *own* divergence.
        """
        if self._ckpt_plan is not None:
            return self._ckpt_plan
        sh = self._shared
        ret = sh.get("retune")
        if ret is not None:
            cont = self._recorded_leg(
                fleet_kwargs=self._fleet_kwargs("ckpt"),
                fork=_Fork(ret.tick, ret.blob, self._strip(ret.events)),
                scrub_tuning=True,
            )
            if cont["status"] == "completed":
                self._ckpt_plan = ("done", cont["events"])
            else:
                self._ckpt_plan = ("fork", cont["fork"])
        elif sh["status"] == "completed":
            self._ckpt_plan = ("done", self._strip(sh["events"]))
        else:
            f = sh["fork"]
            self._ckpt_plan = (
                "fork",
                _Fork(f.tick, f.blob, self._strip(f.events))
                if f is not None else None,
            )
        return self._ckpt_plan

    @staticmethod
    def _strip(events) -> list:
        return [e for e in events if not isinstance(e, ScreenTuning)]

    @staticmethod
    def _scrub_tuning(plane: ControlPlane) -> None:
        """Turn a restored falcon-semantics screen into ckpt's: adaptation
        off (restore re-applies the snapshot's ``adapt_every``) and the
        retune mirror cleared. The screening *values* at the fork are
        already ckpt's own — the fork precedes the first value-changing
        retune by construction."""
        plane._last_tuning = None
        if plane._fleet is not None:
            plane._fleet.adapt_every = 0
            plane._fleet.last_tuning = None

    def _branch(
        self,
        mode: str,
        *,
        planner_knobs=None,
        decision_hook=None,
        planner_trace=None,
    ) -> RunResult:
        kind, payload = (
            self._falcon_plan() if mode == "falcon" else self._ckpt()
        )
        if kind == "done":
            # No intervention ever happened: knobs and hooks had nothing
            # to act on, and the whole run is the recording.
            self.stats["reused_runs"] += 1
            return self._result_from_recording(mode, payload)
        if payload is None:
            # Divergence on the very first tick — nothing to share.
            self.stats["fresh_runs"] += 1
        else:
            self.stats["forked_runs"] += 1
        return self._full_leg(
            mode, fork=payload, planner_knobs=planner_knobs,
            decision_hook=decision_hook, planner_trace=planner_trace,
        )

    # -- decision-trace memo ---------------------------------------------
    def _probe_traces(self, mode: str, knobs: PlannerKnobs) -> RunResult | None:
        """A cached run whose recorded decision sequence ``knobs`` would
        reproduce exactly, if any — decisions equal implies the whole run
        is equal (knobs act on nothing else)."""
        for entry in self._traces.get(mode, ()):
            if all(
                (r["impact"] > threshold_value(knobs, r)) == r["decision"]
                for r in entry["trace"]
            ):
                self.stats["trace_hits"] += 1
                return entry["result"]
        return None

    # -- recorded results ------------------------------------------------
    def _finished_outcome(self, placed) -> JobOutcome:
        jr = self.rec.jobs[placed.job_id]
        dt = self.spec.preset.tick_seconds
        out = JobOutcome(
            job_id=placed.job_id, join_time=placed.join_tick * dt,
            steps=placed.steps,
        )
        out.iters_done = jr.iters[-1] if jr.iters else 0.0
        out.stalled_ticks = jr.stalled[-1] if jr.stalled else 0
        if jr.end_tick is not None:
            out.end_time = (jr.end_tick + 1) * dt
        return out

    def _result_from_recording(self, mode: str, events: list) -> RunResult:
        outcomes = {
            p.job_id: self._finished_outcome(p) for p in self._join_order()
        }
        return RunResult(
            mode=mode, outcomes=outcomes, events=list(events),
            ticks_run=self.rec.ticks_run,
            horizon_s=self.spec.max_ticks * self.spec.preset.tick_seconds,
            touched_jobs=frozenset(),
        )

    # -- the shared recorded plane leg -----------------------------------
    def _recorded_leg(
        self,
        *,
        fleet_kwargs: dict,
        fork: _Fork | None = None,
        watch_retune: bool = False,
        scrub_tuning: bool = False,
    ) -> dict:
        """Drive a plane over the recorded samples until it diverges.

        All jobs are virtual (lazy holders); the plane sees exactly the
        sample stream, joins and leaves the fresh run would deliver, and a
        rolling snapshot marks every prospective fork point. Returns
        ``{"status": "diverged", "fork": _Fork, "retune": _Fork | None}``
        or ``{"status": "completed", "events": [...], "retune": ...}``.
        """
        spec = self.spec
        preset = spec.preset
        dt = preset.tick_seconds
        rec = self.rec
        plane = ControlPlane(max_events=1 << 20, fleet_kwargs=fleet_kwargs)
        pending = self._join_order()
        start_tick = 0
        live: set[str] = set()
        prev_fork: _Fork | None = None
        retune: _Fork | None = None
        if fork is not None:
            start_tick = fork.tick
            pending = [p for p in pending if p.join_tick >= start_tick]
            by_id = {p.job_id: p for p in spec.jobs}
            for job_id in fork.blob["jobs"]:
                placed = by_id[job_id]
                holder = _JobHolder(self, placed)
                plane.adopt_job(
                    job_id, holder.sim_proxy, state=fork.blob["jobs"][job_id],
                    overheads=preset.overheads(),
                    injector=holder.injector_proxy,
                    hardware=placed.hardware(), hosts=placed.hosts(),
                    sample_period=dt,
                )
                live.add(job_id)
            plane.restore(fork.blob, events=fork.events)
            if scrub_tuning:
                self._scrub_tuning(plane)
            prev_fork = fork

        def _resolve(f: _Fork | None, full: list) -> _Fork | None:
            if f is not None and f.events is None:
                f.events = full[: f.blob["n_events"]]
            return f

        for tick in range(start_tick, spec.max_ticks):
            self.cur_tick = tick
            now = tick * dt
            while pending and pending[0].join_tick <= tick:
                placed = pending.pop(0)
                holder = _JobHolder(self, placed)
                plane.register_job(
                    placed.job_id, holder.sim_proxy,
                    overheads=preset.overheads(),
                    injector=holder.injector_proxy,
                    hardware=placed.hardware(), hosts=placed.hosts(),
                    sample_period=dt, now=now,
                )
                live.add(placed.job_id)
            if not live and not pending:
                break
            now_end = (tick + 1) * dt
            if live:
                samples = {
                    j: v for j, v in rec.samples[tick].items() if j in live
                }
                fleet = plane._fleet
                prev_vals = (
                    (fleet.hazard, fleet.max_hypotheses)
                    if fleet is not None else None
                )
                prev_tuning = plane._last_tuning
                new_events = plane.tick(samples, now_end)
                if any(
                    not isinstance(ev, (Observation, ScreenTuning))
                    for ev in new_events
                ):
                    full = list(plane.events)
                    return {
                        "status": "diverged",
                        "fork": _resolve(prev_fork, full),
                        "retune": _resolve(retune, full),
                    }
                if (
                    watch_retune
                    and retune is None
                    and plane._last_tuning is not prev_tuning
                ):
                    after = (
                        plane._fleet.hazard, plane._fleet.max_hypotheses
                    )
                    if prev_vals is None or after != prev_vals:
                        retune = prev_fork
                for job_id in list(live):
                    if rec.jobs[job_id].end_tick == tick:
                        plane.remove_job(job_id, now_end)
                        live.discard(job_id)
                blob = plane.snapshot()
                prev_fork = _Fork(tick + 1, blob, None)
        full = list(plane.events)
        return {
            "status": "completed",
            "events": full,
            "retune": _resolve(retune, full),
        }

    # -- the full-fidelity leg -------------------------------------------
    def _full_leg(
        self,
        mode: str,
        *,
        fork: _Fork | None = None,
        planner_knobs=None,
        decision_hook=None,
        planner_trace=None,
        record: bool = False,
    ):
        """One campaign run, mirroring :func:`run_campaign` operation for
        operation — with three extensions: it can *record* the trajectory
        (the faults leg), *fork* from a shared-prefix snapshot, and keep
        untouched jobs *virtual* on the recording until the plane touches
        them."""
        spec = self.spec
        preset = spec.preset
        dt = preset.tick_seconds
        with_faults = mode != "healthy"
        with_plane = mode in ("ckpt", "falcon")
        serve = self.rec if not record else None
        rec = _Recording() if record else None
        plane = None
        if with_plane:
            fail_p, timeout_p = preset.executor_faults
            plane = ControlPlane(
                max_events=1 << 20,
                fleet_kwargs=self._fleet_kwargs(mode),
                duration_model=DurationModel() if mode == "falcon" else None,
                executor_faults=(
                    ExecutorFaultModel(fail_p, timeout_p, seed=spec.seed)
                    if fail_p > 0.0 or timeout_p > 0.0 else None
                ),
                decision_hook=decision_hook,
                planner_knobs=planner_knobs,
                planner_trace=planner_trace,
            )

        pending = self._join_order()
        live: dict[str, dict] = {}
        outcomes: dict[str, JobOutcome] = {}
        ticks = 0
        start_tick = 0
        touched: set[str] = set()

        def _work_remaining(out, placed):
            return (
                lambda o=out, t=placed.healthy_iter_time:
                max(o.steps - o.iters_done, 0.0) * t
            )

        if fork is not None:
            start_tick = fork.tick
            ticks = fork.tick
            pending = [p for p in pending if p.join_tick >= start_tick]
            by_id = {p.job_id: p for p in spec.jobs}
            for job_id in fork.blob["jobs"]:
                placed = by_id[job_id]
                jr = serve.jobs[job_id]
                out = JobOutcome(
                    job_id=job_id, join_time=placed.join_tick * dt,
                    steps=placed.steps,
                )
                out.iters_done = jr.iters_at(start_tick - 1)
                out.stalled_ticks = jr.stalled_at(start_tick - 1)
                outcomes[job_id] = out
                st = {
                    "placed": placed, "sim": None, "injector": None,
                    "debt": 0.0, "rng": None,
                    "gids": frozenset(placed.global_ids), "epoch": None,
                    "virtual": True,
                }
                holder = _JobHolder(self, placed, st=st)
                st["holder"] = holder
                live[job_id] = st
                plane.adopt_job(
                    job_id, holder.sim_proxy,
                    state=fork.blob["jobs"][job_id],
                    registry=_registry_for(mode),
                    overheads=preset.overheads(),
                    injector=holder.injector_proxy,
                    hardware=placed.hardware(), hosts=placed.hosts(),
                    sample_period=dt,
                    work_remaining=_work_remaining(out, placed),
                )
            plane.restore(fork.blob, events=fork.events)
            if mode == "ckpt":
                self._scrub_tuning(plane)
            for placed in spec.jobs:
                if placed.job_id in outcomes or placed.join_tick >= start_tick:
                    continue
                # Finished on the shared prefix: the recording is the run.
                outcomes[placed.job_id] = self._finished_outcome(placed)

        for tick in range(start_tick, spec.max_ticks):
            self.cur_tick = tick
            now = tick * dt
            while pending and pending[0].join_tick <= tick:
                placed = pending.pop(0)
                out = JobOutcome(
                    job_id=placed.job_id, join_time=now, steps=placed.steps
                )
                outcomes[placed.job_id] = out
                if serve is not None and with_plane:
                    # Post-fork joiners start virtual too.
                    st = {
                        "placed": placed, "sim": None, "injector": None,
                        "debt": 0.0, "rng": None,
                        "gids": frozenset(placed.global_ids), "epoch": None,
                        "virtual": True,
                    }
                    holder = _JobHolder(self, placed, st=st)
                    st["holder"] = holder
                    live[placed.job_id] = st
                    plane.register_job(
                        placed.job_id, holder.sim_proxy,
                        registry=_registry_for(mode),
                        overheads=preset.overheads(),
                        injector=holder.injector_proxy,
                        hardware=placed.hardware(), hosts=placed.hosts(),
                        sample_period=dt,
                        work_remaining=_work_remaining(out, placed),
                        now=now,
                    )
                else:
                    sim = placed.make_sim(self.device)
                    injector = FailSlowInjector(
                        list(placed.local_schedule) if with_faults else []
                    )
                    st = {
                        "placed": placed, "sim": sim, "injector": injector,
                        "debt": 0.0,
                        "rng": np.random.default_rng(
                            [spec.seed, 7, int(placed.job_id[1:])]
                        ),
                        "gids": frozenset(placed.global_ids), "epoch": None,
                        "virtual": False,
                    }
                    live[placed.job_id] = st
                    if plane is not None:
                        plane.register_job(
                            placed.job_id, sim,
                            registry=_registry_for(mode),
                            overheads=preset.overheads(),
                            injector=injector,
                            hardware=placed.hardware(), hosts=placed.hosts(),
                            sample_period=dt,
                            work_remaining=_work_remaining(out, placed),
                            now=now,
                        )
                if record:
                    rec.jobs[placed.job_id] = _JobRec(tick)
            if not live and not pending:
                break
            ticks = tick + 1
            now_end = (tick + 1) * dt

            changed = (
                _changed_episodes(spec.schedule, (tick - 1) * dt, now, dt)
                if with_faults else ()
            )
            samples: dict[str, float] = {}
            for job_id, st in live.items():
                if st["virtual"]:
                    s = serve.samples[tick].get(job_id)
                    if s is None:
                        outcomes[job_id].stalled_ticks += 1
                    else:
                        samples[job_id] = s
                    continue
                injector = st["injector"]
                if st["epoch"] != injector.epoch or (
                    changed and not st["gids"].isdisjoint(changed)
                ):
                    injector.apply(st["sim"].state, now)
                    st["epoch"] = injector.epoch
                if with_faults and st["sim"].stalled():
                    outcomes[job_id].stalled_ticks += 1
                    continue
                samples[job_id] = st["sim"].iteration_time() * float(
                    st["rng"].normal(1.0, preset.jitter)
                )
            if record:
                rec.samples.append(dict(samples))
                for job_id in live:
                    jr = rec.jobs[job_id]
                    jr.draws.append(
                        (jr.draws[-1] if jr.draws else 0)
                        + (1 if job_id in samples else 0)
                    )
                    jr.stalled.append(outcomes[job_id].stalled_ticks)

            if plane is not None and live:
                new_events = plane.tick(samples, now_end)
                for ev in new_events:
                    if isinstance(ev, (Observation, ScreenTuning)):
                        continue
                    jid = getattr(ev, "job_id", "")
                    if not jid:
                        continue
                    touched.add(jid)
                    st = live.get(jid)
                    if st is not None and st["virtual"]:
                        st["holder"].materialize()
                for ev in new_events:
                    if (
                        isinstance(ev, MitigationResult)
                        and ev.kind == "mitigate"
                    ):
                        st = live.get(ev.job_id)
                        if st is None:
                            continue
                        if ev.applied or ev.status != "ok":
                            st["debt"] += ev.overhead
                        if ev.applied:
                            out = outcomes[ev.job_id]
                            label = (
                                ev.strategy.name
                                if hasattr(ev.strategy, "name")
                                else str(ev.strategy)
                            )
                            out.mitigations[label] = (
                                out.mitigations.get(label, 0) + 1
                            )

            finished: list[str] = []
            for job_id, st in live.items():
                out = outcomes[job_id]
                if st["virtual"]:
                    out.iters_done = serve.jobs[job_id].iters_at(tick)
                else:
                    budget = dt
                    pay = min(st["debt"], budget)
                    st["debt"] -= pay
                    budget -= pay
                    out.overhead_paid += pay
                    if job_id in samples:
                        out.iters_done += budget / max(samples[job_id], 1e-12)
                if out.iters_done >= out.steps:
                    out.end_time = now_end
                    finished.append(job_id)
            if record:
                for job_id in live:
                    rec.jobs[job_id].iters.append(outcomes[job_id].iters_done)
            for job_id in finished:
                if record:
                    rec.jobs[job_id].end_tick = tick
                del live[job_id]
                if plane is not None:
                    plane.remove_job(job_id, now_end)

        events = list(plane.events) if plane is not None else []
        order = {
            p.job_id: i for i, p in enumerate(self._join_order())
        }
        outcomes = dict(
            sorted(outcomes.items(), key=lambda kv: order[kv[0]])
        )
        result = RunResult(
            mode=mode, outcomes=outcomes, events=events, ticks_run=ticks,
            horizon_s=spec.max_ticks * dt,
            touched_jobs=frozenset(touched) if with_plane else None,
        )
        if record:
            rec.ticks_run = ticks
            return result, rec
        return result
