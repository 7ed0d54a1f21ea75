"""Campaign runner — multi-job fleets under fail-slow workloads.

Builds a deterministic :class:`CampaignSpec` from a preset + seed (job
placement on the shared hardware map, join schedule, fleet-level fault
schedule and its per-job translations), then executes it under one of four
mitigation modes:

* ``healthy`` — no faults, no control plane: the JCT floor.
* ``faults``  — faults on, no mitigation: the JCT ceiling.
* ``ckpt``    — faults on, detection + checkpoint-restart-only ladder: the
  baseline the paper compares its multi-level mitigation against.
* ``falcon``  — faults on, full S1-S4 ski-rental ladder.

The clock is a *sampling* clock: one tick = ``preset.tick_seconds`` of
simulated wall time, in which every live job's current iteration time is
sampled once (exactly how a fleet monitor scrapes heterogeneous jobs whose
iteration periods differ). A job completes ``tick_seconds / iter_time``
iterations per tick — minus time spent paying one-off mitigation overheads
— and *leaves the campaign* when its quota is done, while later jobs join
mid-flight: the control plane's dynamic-membership path (warming cohorts,
frontier sub-slicing) is on the hot path of every churny campaign.

This is the twin of the reference's ``scenarios/campaign.py``. Every
simulator and fleet screen a run builds takes ``device`` (None = the card,
raising when there is none — :mod:`repro_torch.device`). On the card the
default (``auto``) screen is the CUDA ``bocd_step`` kernel in float32 and the
default reduction is :class:`~repro_torch.cluster.simulator.CudaReduction`;
with ``device="cpu"`` they are the plain ``torch`` step in float64 and
:class:`~repro_torch.cluster.simulator.TorchReduction`. No preset places a
job with tp, dp and pp all above 1, so neither reduction launches anything:
their evaluation returns None for such a topology and the simulator's numpy
path runs, exactly as the reference's ``pallas`` reduction does there.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.cluster.injector import FailSlowInjector, Injection, InjectionKind
from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
from repro_torch.cluster.spec import ClusterSpec, ClusterState
from repro_torch.controlplane import (
    CkptRestartStrategy,
    ControlPlane,
    IgnoreStrategy,
    MitigationResult,
    StrategyRegistry,
    placement_registry,
)
from repro_torch.core.duration import DurationModel
from repro_torch.scenarios.faults import ExecutorFaultModel
from repro_torch.scenarios.presets import JobTemplate, ScenarioPreset, get_preset

MODES = ("healthy", "faults", "ckpt", "falcon")


@dataclass(frozen=True)
class PlacedJob:
    """One job instance pinned to its slice of the shared hardware map."""

    job_id: str
    template: JobTemplate
    #: global device ids, in local-rank order
    devices: tuple[int, ...]
    #: global node ids, in local-node order
    nodes: tuple[int, ...]
    join_tick: int
    steps: int
    #: this job's view of the fleet schedule, in local coordinates
    local_schedule: tuple[Injection, ...]
    #: relative iteration-time impact of each local episode applied alone
    #: to a healthy cluster at full severity (parallel to local_schedule)
    impacts: tuple[float, ...]
    #: indices into the campaign's global schedule (parallel again)
    global_ids: tuple[int, ...]
    healthy_iter_time: float

    @property
    def local_cluster(self) -> ClusterSpec:
        q = len(self.devices) // len(self.nodes)
        return ClusterSpec(n_nodes=len(self.nodes), gpus_per_node=q)

    def make_sim(self, device=None) -> TrainingSimulator:
        """A fresh simulator of this job's slice on ``device`` (None = the
        card); the numpy reduction backends ignore it."""
        return TrainingSimulator(
            cluster=self.local_cluster,
            job=JobSpec(
                model=self.template.model_spec(),
                tp=self.template.tp,
                dp=self.template.dp,
                pp=self.template.pp,
                micro_batches=self.template.micro_batches,
            ),
            device=device,
        )

    def hardware(self) -> list[str]:
        return [f"g{d}" for d in self.devices]

    def hosts(self) -> list[str]:
        return [f"n{n}" for n in self.nodes]


@dataclass(frozen=True)
class CampaignSpec:
    """Everything a campaign run needs, fixed by (preset, jobs, seed)."""

    preset: ScenarioPreset
    seed: int
    n_nodes: int
    jobs: tuple[PlacedJob, ...]
    schedule: tuple[Injection, ...]  # fleet coordinates

    @property
    def tick_seconds(self) -> float:
        return self.preset.tick_seconds

    @property
    def max_ticks(self) -> int:
        return self.preset.max_ticks


@dataclass
class JobOutcome:
    """Per-job result of one campaign run."""

    job_id: str
    join_time: float
    end_time: float | None = None  # None = censored at the horizon
    iters_done: float = 0.0
    steps: int = 0
    overhead_paid: float = 0.0
    #: ticks spent fully stalled (hang active, no samples emitted)
    stalled_ticks: int = 0
    mitigations: dict = field(default_factory=dict)  # strategy label -> count

    @property
    def finished(self) -> bool:
        return self.end_time is not None

    def jct(self, horizon_s: float) -> float:
        return (self.end_time if self.finished else horizon_s) - self.join_time


@dataclass
class RunResult:
    mode: str
    outcomes: dict[str, JobOutcome]
    events: list  # control-plane event log ([] for plane-less modes)
    ticks_run: int
    horizon_s: float
    #: the run's :class:`repro_torch.obs.SpanTracer` when observability was on
    #: (``run_campaign(..., tracer=...)``); None otherwise
    tracer: object | None = None
    #: jobs the control plane actually intervened on (flagged, alarmed,
    #: or mitigated) when the shared-prefix engine produced this run —
    #: every other job rode the recorded fault-mode trajectory verbatim.
    #: None = fresh execution (no divergence tracking was performed).
    touched_jobs: frozenset | None = None


# ------------------------------------------------------------------ build
class _Packer:
    """First-fit placement of job slices onto the shared fleet.

    Whole-node jobs take nodes outright; sub-node jobs (``span_nodes``
    slices of q devices) take the lowest free q-block of each chosen node,
    so two 4-GPU jobs land co-located on one 8-GPU node and two half-node
    slices of a 2-node job straddle a node pair — the co-location patterns
    the dedupe scenarios need. The fleet grows as needed.
    """

    def __init__(self, gpus_per_node: int) -> None:
        self.gpn = gpus_per_node
        self.free: list[list[int]] = []  # per node, ascending free devices

    def _grow(self) -> int:
        node = len(self.free)
        self.free.append(
            [node * self.gpn + i for i in range(self.gpn)]
        )
        return node

    def place(self, template: JobTemplate) -> tuple[list[int], list[int]]:
        n = template.n_devices
        span = template.span_nodes
        if span == 0:
            span = max(1, n // self.gpn) if n % self.gpn == 0 else 1
        if n % span:
            raise ValueError(f"{n} devices cannot span {span} nodes evenly")
        q = n // span
        if q > self.gpn:
            raise ValueError(
                f"{q} devices per node > {self.gpn} gpus_per_node"
            )
        nodes: list[int] = []
        for node, free in enumerate(self.free):
            if len(free) >= q:
                nodes.append(node)
                if len(nodes) == span:
                    break
        while len(nodes) < span:
            nodes.append(self._grow())
        devices: list[int] = []
        for node in nodes:
            take, self.free[node] = (
                self.free[node][:q], self.free[node][q:]
            )
            devices += take
        return devices, nodes

    @property
    def n_nodes(self) -> int:
        return len(self.free)


def _translate(
    inj: Injection,
    dev_inverse: dict[int, int],
    node_inverse: dict[int, int],
) -> Injection | None:
    """A fleet-coordinate episode in one job's local coordinates (None =
    the job's slice is untouched by it)."""
    if inj.kind in (InjectionKind.GPU_SLOW, InjectionKind.GPU_HANG):
        (d,) = inj.target
        if d in dev_inverse:
            return replace(inj, target=(dev_inverse[d],))
        return None
    if inj.kind in (InjectionKind.CPU_CONTENTION, InjectionKind.NIC_CONGESTION):
        (n,) = inj.target
        if n in node_inverse:
            return replace(inj, target=(node_inverse[n],))
        return None
    a, b = inj.target
    if a in dev_inverse and b in dev_inverse:
        return replace(inj, target=(dev_inverse[a], dev_inverse[b]))
    return None


def _impacts(
    sim: TrainingSimulator, episodes: list[Injection]
) -> list[float]:
    """Relative iteration-time increase of each episode at full severity,
    applied alone to a healthy cluster — the ground-truth observability of
    the fault for this job (a congested link no ring traverses is harmless).

    One probe state and one injector are reused across the whole schedule:
    swapping episode ``i`` out for ``i+1`` restores and degrades only the
    two episodes' components (the injector's diff-apply), so every probe
    evaluation after the first re-reduces only the touched cells instead of
    rebuilding the vectorized pass per episode.
    """
    t_h = sim.healthy_iteration_time()
    probe = ClusterState(sim.cluster)
    inj = FailSlowInjector()
    saved = sim.state
    sim.state = probe
    try:
        out = []
        for local in episodes:
            inj.injections = [
                replace(local, start=0.0, duration=1.0, ramp=0.0)
            ]
            inj.apply(probe, 0.5)
            out.append(sim.iteration_time() / t_h - 1.0)
    finally:
        sim.state = saved
    return out


def build_campaign(
    preset: ScenarioPreset | str,
    n_jobs: int | None = None,
    seed: int = 0,
    max_ticks: int | None = None,
    device=None,
) -> CampaignSpec:
    """Deterministically expand (preset, jobs, seed) into a campaign spec.

    ``device`` is where the probe simulators that measure each episode's
    impact run their reduction (None = the card); the spec does not depend
    on it."""
    if isinstance(preset, str):
        preset = get_preset(preset)
    if max_ticks is not None:
        preset = replace(preset, max_ticks=max_ticks)
    n_jobs = n_jobs or preset.default_jobs
    rng = np.random.default_rng([seed, 0xFA1C])
    dt = preset.tick_seconds
    horizon_s = preset.max_ticks * dt

    packer = _Packer(preset.gpus_per_node)
    for _ in range(preset.n_nodes):
        packer._grow()

    # Joins: job 0 anchors the fleet at tick 0, the rest stagger (churn).
    joins = [0] + sorted(
        int(rng.integers(0, preset.join_spread_ticks + 1))
        for _ in range(n_jobs - 1)
    )

    placements = []
    for i in range(n_jobs):
        template = preset.job_templates[i % len(preset.job_templates)]
        devices, nodes = packer.place(template)
        placements.append((template, devices, nodes))

    # Fleet-level fault schedule: preset's fixed episodes + sampled model.
    schedule: list[Injection] = []
    if preset.fixed_schedule is not None:
        schedule += preset.fixed_schedule(
            packer.n_nodes, preset.gpus_per_node, dt
        )
    if preset.fault_model is not None:
        schedule += preset.fault_model.sample_schedule(
            rng, packer.n_nodes, preset.gpus_per_node, horizon_s
        )
    schedule.sort(key=lambda i: (i.start, i.kind.value, i.target))

    jobs: list[PlacedJob] = []
    for i, (template, devices, nodes) in enumerate(placements):
        dev_inverse = {d: k for k, d in enumerate(devices)}
        node_inverse = {n: k for k, n in enumerate(nodes)}
        placed = PlacedJob(
            job_id=f"j{i}", template=template, devices=tuple(devices),
            nodes=tuple(nodes), join_tick=joins[i], steps=0,
            local_schedule=(), impacts=(), global_ids=(),
            healthy_iter_time=0.0,
        )
        sim = placed.make_sim(device)
        it_h = sim.healthy_iteration_time()
        translated: list[tuple[int, Injection]] = []
        for gi, inj in enumerate(schedule):
            local = _translate(inj, dev_inverse, node_inverse)
            if local is not None:
                translated.append((gi, local))
        probed = _impacts(sim, [local for _, local in translated])
        locals_: list[Injection] = []
        impacts: list[float] = []
        gids: list[int] = []
        for (gi, local), impact in zip(translated, probed):
            if impact <= 1e-9:
                continue
            locals_.append(local)
            impacts.append(impact)
            gids.append(gi)
        # Auto quota: finish well inside the horizon even when fail-slows
        # stretch the job's effective iteration time (censored JCTs would
        # void the healthy/faults/falcon comparison).
        steps = template.steps or max(
            30,
            int(
                float(rng.uniform(0.3, 0.5))
                * (preset.max_ticks - joins[i]) * dt / it_h
            ),
        )
        jobs.append(replace(
            placed,
            steps=steps,
            local_schedule=tuple(locals_),
            impacts=tuple(impacts),
            global_ids=tuple(gids),
            healthy_iter_time=it_h,
        ))
    return CampaignSpec(
        preset=preset, seed=seed, n_nodes=packer.n_nodes,
        jobs=tuple(jobs), schedule=tuple(schedule),
    )


# -------------------------------------------------------------------- run
def _changed_episodes(
    schedule: tuple[Injection, ...], prev: float, now: float, dt: float
) -> set[int]:
    """Global schedule indices whose activity or effective severity can
    differ between ``prev`` and ``now`` — the fleet-level event feed the
    per-job fault cursors consume. Episodes starting or ending inside the
    window transition; a ramping episode moves every tick until one full
    tick after its ramp completes (the first tick *at* full severity is
    itself a change from the last partial value)."""
    out: set[int] = set()
    for gi, inj in enumerate(schedule):
        if prev < inj.start <= now or prev < inj.end <= now:
            out.add(gi)
        elif (
            inj.active(now)
            and inj.ramp > 0.0
            and now - inj.start < inj.ramp + dt
        ):
            out.add(gi)
    return out


def _registry_for(mode: str):
    if mode == "falcon":
        # The full ladder including the placement rungs (S2P/S3P).
        return placement_registry()
    # Checkpoint-restart baseline: detection on, but the only mitigation
    # mechanism is the paper's S4 (what pre-FALCON production systems do).
    return (
        StrategyRegistry()
        .register(IgnoreStrategy())
        .register(CkptRestartStrategy())
    )


def run_campaign(
    spec: CampaignSpec,
    mode: str,
    *,
    drop_episodes=None,
    decision_hook=None,
    planner_knobs=None,
    only_jobs=None,
    tracer=None,
    screening_backend=None,
    reduction_backend=None,
    device=None,
) -> RunResult:
    """Execute one campaign under the given mitigation mode.

    The keyword surface is the what-if engine's replay contract (the
    reference's ``whatif/`` package; its account is docs/whatif.md, and the
    port's twin of that package is still to come):

    * ``drop_episodes`` — global schedule indices to remove before the run
      (counterfactual "what if this fault never happened"). Dropping every
      episode reproduces the ``healthy`` run bit-exactly: the per-job rng
      streams depend only on (seed, job) and an empty injector leaves the
      simulator state untouched.
    * ``decision_hook`` — forwarded to :class:`ControlPlane`: suppress /
      force individual mitigation decisions (see the plane's hook
      contract). Suppressing everything reproduces the ``faults`` run
      bit-exactly for the same reason.
    * ``planner_knobs`` — a :class:`~repro_torch.core.planner.PlannerKnobs`
      bundle applied to every planner the plane builds (the auto-tuner's
      injection point).
    * ``only_jobs`` — run just these job ids. Valid only for the
      plane-less modes (``healthy`` / ``faults``), where jobs never
      interact: each job's trajectory there is bit-identical whether or
      not its neighbours run, which is what makes affected-jobs-only
      replay exact and cheap.
    * ``screening_backend`` — fleet-screen backend override forwarded to
      :class:`ControlPlane` (a ``SCREENING_BACKENDS`` registry name or
      factory instance); None keeps the plane's default.
    * ``reduction_backend`` — per-simulator reduction backend override (a
      ``REDUCTION_BACKENDS`` registry name or instance) assigned to every
      job simulator this run builds; None keeps the simulator default
      ("auto").
    * ``device`` — the torch device of every job simulator and of the fleet
      screen (None = the card, raising when there is none); the numpy
      backends (``batched``, ``vectorized``) ignore it.
    * ``tracer`` — a :class:`repro_torch.obs.SpanTracer` on the campaign's
      simulated clock. The runner records each job's lifetime span and its
      injected fault episodes (ground truth lanes); the control plane adds
      tick, detector, watchdog, executor, and diagnosed-fault spans. The
      tracer is returned on :attr:`RunResult.tracer` with every track
      closed at the horizon. Tracing never alters the run: all call sites
      are guarded, rng streams and event logs are bit-identical with or
      without it.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    preset = spec.preset
    dt = preset.tick_seconds
    with_faults = mode != "healthy"
    with_plane = mode in ("ckpt", "falcon")
    campaign_jobs = spec.jobs
    if only_jobs is not None:
        if with_plane:
            raise ValueError(
                "only_jobs is exact only for plane-less modes: under a "
                "control plane jobs couple through dedupe, the shared "
                "duration model, and the incident gap"
            )
        keep = set(only_jobs)
        campaign_jobs = tuple(j for j in campaign_jobs if j.job_id in keep)
    drop = frozenset(drop_episodes or ())
    if drop:
        campaign_jobs = tuple(
            replace(
                p,
                local_schedule=tuple(
                    l for l, g in zip(p.local_schedule, p.global_ids)
                    if g not in drop
                ),
                impacts=tuple(
                    i for i, g in zip(p.impacts, p.global_ids)
                    if g not in drop
                ),
                global_ids=tuple(g for g in p.global_ids if g not in drop),
            )
            for p in campaign_jobs
        )
    plane = None
    if with_plane:
        # Only the full FALCON mode gets the predictive ski-rental horizon;
        # the ckpt baseline keeps the classic fixed-horizon break-even.
        fail_p, timeout_p = preset.executor_faults
        fleet_kwargs = {"device": device}
        # Adaptive screening re-tunes are a falcon-mode feature; the ckpt
        # baseline keeps the fixed constructor knobs.
        if mode == "falcon" and preset.adapt_every:
            fleet_kwargs["adapt_every"] = preset.adapt_every
        plane = ControlPlane(
            max_events=1 << 20,
            fleet_kwargs=fleet_kwargs,
            screening_backend=screening_backend,
            duration_model=DurationModel() if mode == "falcon" else None,
            # Fresh per run so ckpt and falcon modes draw identical streams.
            executor_faults=(
                ExecutorFaultModel(fail_p, timeout_p, seed=spec.seed)
                if fail_p > 0.0 or timeout_p > 0.0 else None
            ),
            decision_hook=decision_hook,
            planner_knobs=planner_knobs,
            tracer=tracer,
        )

    pending = sorted(
        campaign_jobs, key=lambda j: (j.join_tick, int(j.job_id[1:]))
    )
    live: dict[str, dict] = {}
    outcomes: dict[str, JobOutcome] = {}
    ticks = 0

    for tick in range(spec.max_ticks):
        now = tick * dt
        while pending and pending[0].join_tick <= tick:
            placed = pending.pop(0)
            sim = placed.make_sim(device)
            if reduction_backend is not None:
                sim.reduction = reduction_backend
            injector = FailSlowInjector(
                list(placed.local_schedule) if with_faults else []
            )
            live[placed.job_id] = {
                "placed": placed,
                "sim": sim,
                "injector": injector,
                "debt": 0.0,
                "rng": np.random.default_rng(
                    [spec.seed, 7, int(placed.job_id[1:])]
                ),
                # per-job fault cursor over the fleet schedule: which global
                # episodes touch this job, and the injector epoch last
                # applied (None forces the join-tick apply)
                "gids": frozenset(placed.global_ids),
                "epoch": None,
            }
            out = JobOutcome(
                job_id=placed.job_id, join_time=now, steps=placed.steps
            )
            outcomes[placed.job_id] = out
            if tracer is not None:
                horizon_s = spec.max_ticks * dt
                tracer.begin(
                    (placed.job_id, "job"), "job", now,
                    args={
                        "devices": len(placed.devices),
                        "steps": placed.steps,
                        "template": placed.template.arch,
                    },
                )
                if with_faults:
                    # Ground-truth lane: the injected episodes as scheduled,
                    # before any detection — lining this track up against
                    # the plane's "faults" track is the detection-latency /
                    # miss picture a dashboard wants.
                    for inj in placed.local_schedule:
                        tracer.span(
                            (placed.job_id, "injected"),
                            f"inject:{inj.kind.value}",
                            inj.start, min(inj.end, horizon_s),
                            args={
                                "target": list(inj.target),
                                "severity": inj.severity,
                            },
                        )
            if plane is not None:
                plane.register_job(
                    placed.job_id, sim,
                    registry=_registry_for(mode),
                    overheads=preset.overheads(),
                    injector=injector,
                    hardware=placed.hardware(),
                    hosts=placed.hosts(),
                    sample_period=dt,
                    # The predictive break-even caps any mitigation's
                    # benefit by the job's remaining useful work.
                    work_remaining=(
                        lambda o=out, t=placed.healthy_iter_time:
                        max(o.steps - o.iters_done, 0.0) * t
                    ),
                    now=now,
                )
        if not live and not pending:
            break
        ticks = tick + 1
        now_end = (tick + 1) * dt

        # Fleet-level fault transitions this tick; each job consumes them
        # through its own cursor (episode subset + injector epoch), so jobs
        # untouched by an event pay nothing — no per-job schedule scan, no
        # cross-job invalidation of memoized iteration times.
        changed = (
            _changed_episodes(spec.schedule, (tick - 1) * dt, now, dt)
            if with_faults else ()
        )
        samples: dict[str, float] = {}
        for job_id, st in live.items():
            injector = st["injector"]
            if st["epoch"] != injector.epoch or (
                changed and not st["gids"].isdisjoint(changed)
            ):
                injector.apply(st["sim"].state, now)
                st["epoch"] = injector.epoch
            if with_faults and st["sim"].stalled():
                # A hung job emits nothing: the collective never returns, so
                # there is no iteration-time sample this tick (and no jitter
                # draw — the rng stream restarts when the job resumes).
                outcomes[job_id].stalled_ticks += 1
                continue
            samples[job_id] = st["sim"].iteration_time() * float(
                st["rng"].normal(1.0, preset.jitter)
            )

        # Tick whenever jobs are live, even if every one of them is stalled
        # this tick — the silent path IS the watchdog's input.
        if plane is not None and live:
            new_events = plane.tick(samples, now_end)
            for ev in new_events:
                if isinstance(ev, MitigationResult) and ev.kind == "mitigate":
                    st = live.get(ev.job_id)
                    if st is None:
                        continue
                    # Applied dispatches pay the strategy overhead; failed
                    # attempts pay their timeout/backoff charge. A declined
                    # dispatch (ok but not applied — e.g. no better
                    # placement) did nothing and costs nothing.
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
            budget = dt
            pay = min(st["debt"], budget)
            st["debt"] -= pay
            budget -= pay
            out = outcomes[job_id]
            out.overhead_paid += pay
            if job_id in samples:
                out.iters_done += budget / max(samples[job_id], 1e-12)
            if out.iters_done >= out.steps:
                out.end_time = now_end
                finished.append(job_id)
        for job_id in finished:
            del live[job_id]
            if tracer is not None:
                tracer.end(
                    (job_id, "job"), now_end,
                    args={"iters": round(outcomes[job_id].iters_done, 3)},
                )
            if plane is not None:
                plane.remove_job(job_id, now_end)

    events = list(plane.events) if plane is not None else []
    if tracer is not None:
        # Censor everything still open (jobs that ran out the clock, fault
        # episodes never relieved) at the horizon so the trace exports.
        tracer.close_all(spec.max_ticks * dt)
    return RunResult(
        mode=mode, outcomes=outcomes, events=events, ticks_run=ticks,
        horizon_s=spec.max_ticks * dt, tracer=tracer,
    )
