"""Named scenario presets — the campaign catalog.

A :class:`ScenarioPreset` fixes everything about a campaign except the seed
and the job count: the shared fleet, the tick (sampling) interval, the job
templates cycled to fill ``--jobs N``, the churn window, and the fault
workload (a :class:`~repro_torch.scenarios.faults.FaultModel`, a hand-built fixed
schedule, or both). The reference's account of the catalog, and of how
each preset maps onto the paper's evaluation scenarios, is
docs/scenarios.md; this module is its twin, with the same presets.

Job templates draw their transformer shapes from the architecture registry
(``repro_torch.configs``), so a campaign fleet is *heterogeneous*: a 9B dense job
and a 20B job disagree about iteration time, communication volume, and
therefore about how the same fault hurts them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.cluster.injector import Injection, InjectionKind
from repro_torch.cluster.spec import ModelSpec
from repro_torch.configs.base import get_config
from repro_torch.core.events import Strategy, StrategyKey
from repro_torch.scenarios.faults import FaultModel


@dataclass(frozen=True)
class JobTemplate:
    """One hybrid-parallel job shape, cycled to fill the requested fleet.

    ``span_nodes`` is how many fleet nodes the job's devices spread over
    (0 = auto: whole nodes for node-multiple jobs, one node otherwise; 2
    with a sub-node device count places half the job on each of two nodes,
    which is what makes DP rings cross the NIC).
    """

    arch: str
    tp: int = 1
    dp: int = 4
    pp: int = 1
    micro_batches: int = 16
    span_nodes: int = 0
    #: fixed iteration quota; 0 = auto-sized to finish inside the horizon
    steps: int = 0
    seq_len: int = 2048

    @property
    def n_devices(self) -> int:
        return self.tp * self.dp * self.pp

    def model_spec(self) -> ModelSpec:
        cfg = get_config(self.arch)
        return ModelSpec(
            layers=cfg.num_layers,
            hidden=cfg.d_model,
            seq_len=self.seq_len,
            vocab=cfg.vocab_size,
        )


#: a fixed-schedule function: (n_nodes, gpus_per_node, tick_seconds) -> injections
ScheduleFn = Callable[[int, int, float], list[Injection]]


@dataclass(frozen=True)
class ScenarioPreset:
    name: str
    description: str
    #: minimum fleet size; the packer grows it to fit the requested jobs
    n_nodes: int = 2
    gpus_per_node: int = 8
    #: fleet-monitor sampling interval (seconds of simulated wall clock)
    tick_seconds: float = 5.0
    max_ticks: int = 600
    default_jobs: int = 4
    job_templates: tuple[JobTemplate, ...] = ()
    #: joins are staggered uniformly over [0, join_spread_ticks] (0 = all
    #: jobs start at tick 0; job 0 always starts at 0 so the campaign has a
    #: fleet from the first tick)
    join_spread_ticks: int = 0
    fault_model: FaultModel | None = None
    fixed_schedule: ScheduleFn | None = None
    #: checkpoint-restart one-off cost in ticks (the other ladder rungs are
    #: fixed fractions of a tick; the paper's ratios, scaled to the clock)
    ckpt_overhead_ticks: float = 60.0
    #: jitter std-dev of sampled iteration times (healthy noise floor)
    jitter: float = 0.003
    #: (fail_prob, timeout_prob) per mitigation dispatch attempt — wired
    #: into an :class:`~repro_torch.scenarios.faults.ExecutorFaultModel` by the
    #: campaign runner; (0, 0) disables executor faults (and consumes no
    #: rng, keeping existing presets byte-identical)
    executor_faults: tuple[float, float] = (0.0, 0.0)
    #: scoring budget: a hang should be aborted within this many ticks of
    #: its injection (robustness report's deadline_budget_s)
    abort_budget_ticks: float = 12.0
    #: fleet-screen adaptive re-tune period in ticks, applied to the
    #: *falcon* mode only (the ckpt baseline keeps fixed screening knobs so
    #: the comparison stays honest): every this-many ticks FleetDetect
    #: re-derives the hazard / run-length cap from the observed flag rate
    #: (:meth:`repro_torch.core.detector.FleetDetect._retune`). 0 disables.
    adapt_every: int = 50

    def overheads(self) -> dict[StrategyKey, float]:
        """Ski-rental one-off action costs on this preset's clock.

        The placement rungs (S2P/S3P) sit between their paper siblings:
        a group re-shape moves optimizer/parameter shards between the
        swapped ranks, heavier than an S2 re-split but in the same class
        as an S3 placement swap.
        """
        dt = self.tick_seconds
        return {
            Strategy.IGNORE: 0.0,
            Strategy.ADJUST_MICROBATCH: 0.5 * dt,
            "S2P": 1.5 * dt,
            Strategy.ADJUST_TOPOLOGY: 3.0 * dt,
            "S3P": 4.0 * dt,
            "ABORT_REFORM": 6.0 * dt,
            Strategy.CKPT_AND_RESTART: self.ckpt_overhead_ticks * dt,
        }


# ---------------------------------------------------------------- catalog
def _single_gpu_throttle(n_nodes: int, gpn: int, dt: float) -> list[Injection]:
    """The paper's simplest injection: one SM-frequency-locked GPU."""
    return [Injection(start=150 * dt, duration=250 * dt,
                      kind=InjectionKind.GPU_SLOW, target=(3,), severity=0.5)]


def _rack_nic(n_nodes: int, gpn: int, dt: float) -> list[Injection]:
    """Rack-wide congestion: every NIC of the rack's nodes degrades, with
    ramped onsets staggered across nodes (congestion spreads)."""
    return [
        Injection(start=(120 + 30 * n) * dt, duration=220 * dt,
                  kind=InjectionKind.NIC_CONGESTION, target=(n,),
                  severity=0.7, ramp=40 * dt)
        for n in range(min(2, n_nodes))
    ]


def _cascading_hosts(n_nodes: int, gpn: int, dt: float) -> list[Injection]:
    """Host contention cascading node to node (co-located jobs each see it)."""
    return [
        Injection(start=(100 + 90 * n) * dt, duration=260 * dt,
                  kind=InjectionKind.CPU_CONTENTION, target=(n,),
                  severity=0.5)
        for n in range(min(3, n_nodes))
    ]


def _long_tail(n_nodes: int, gpn: int, dt: float) -> list[Injection]:
    """A weak degradation that lasts ~10 simulated hours (Fig. 1's tail)."""
    return [Injection(start=200 * dt, duration=36_000.0,
                      kind=InjectionKind.GPU_SLOW, target=(1,),
                      severity=0.25)]


def _collective_hang(n_nodes: int, gpn: int, dt: float) -> list[Injection]:
    """Two hangs (tentpole scenario): a DP all-reduce collective freezes on
    a cross-node link, then a single GPU hard-hangs on another job. Both
    last far past the horizon budget — only an abort ends them."""
    return [
        Injection(start=150 * dt, duration=400 * dt,
                  kind=InjectionKind.COLLECTIVE_HANG, target=(0, gpn),
                  severity=1.0, scope="dp"),
        Injection(start=220 * dt, duration=400 * dt,
                  kind=InjectionKind.GPU_HANG, target=(4,), severity=1.0),
    ]


def _flaky_faults(n_nodes: int, gpn: int, dt: float) -> list[Injection]:
    """Moderate slowdowns for the flaky-executor preset: ordinary ladder
    work whose dispatches the ExecutorFaultModel then makes fail."""
    return [
        Injection(start=120 * dt, duration=250 * dt,
                  kind=InjectionKind.GPU_SLOW, target=(2,), severity=0.5),
        Injection(start=180 * dt, duration=220 * dt,
                  kind=InjectionKind.NIC_CONGESTION, target=(1,),
                  severity=0.6, ramp=20 * dt),
    ]


_T = JobTemplate  # brevity below

PRESETS: dict[str, ScenarioPreset] = {
    p.name: p
    for p in (
        ScenarioPreset(
            name="single_gpu_throttle",
            description="One job, one SM-throttled GPU (paper §7.1 tier run)",
            n_nodes=1, default_jobs=1, max_ticks=500,
            job_templates=(_T("yi-9b", tp=1, dp=4, pp=2, micro_batches=32),),
            fixed_schedule=_single_gpu_throttle,
        ),
        ScenarioPreset(
            name="rack_nic_congestion",
            description="Rack-wide NIC congestion with ramped onsets; jobs "
                        "straddle node pairs so DP rings cross the NIC",
            n_nodes=4, default_jobs=4, max_ticks=500,
            job_templates=(
                _T("granite-3-8b", tp=4, dp=2, pp=1, micro_batches=16,
                   span_nodes=2),
            ),
            fixed_schedule=_rack_nic,
        ),
        ScenarioPreset(
            name="cascading_host_contention",
            description="CPU contention cascading across nodes; jobs pairwise "
                        "share hosts (node-scoped dedupe) and straddle a "
                        "healthy node, so S2 has skew to exploit",
            n_nodes=4, default_jobs=4, max_ticks=500,
            job_templates=(
                _T("granite-3-8b", tp=2, dp=2, pp=1, micro_batches=16,
                   span_nodes=2),
                _T("yi-9b", tp=1, dp=4, pp=1, micro_batches=32,
                   span_nodes=2),
            ),
            fixed_schedule=_cascading_hosts,
        ),
        ScenarioPreset(
            name="long_tail_degradation",
            description="A weak ~10-hour degradation (the duration CDF's "
                        "tail); coarse 30 s sampling clock",
            n_nodes=2, default_jobs=2, tick_seconds=30.0, max_ticks=1400,
            ckpt_overhead_ticks=60.0,
            job_templates=(
                _T("granite-20b", tp=1, dp=8, pp=2, micro_batches=32),
                _T("yi-9b", tp=1, dp=4, pp=2, micro_batches=32),
            ),
            fixed_schedule=_long_tail,
        ),
        ScenarioPreset(
            name="collective_hang",
            description="Hang anomalies: a frozen DP collective on one job "
                        "and a hard GPU hang on another — the watchdog, not "
                        "BOCD, must flag them and ABORT_REFORM must end them",
            n_nodes=4, default_jobs=2, max_ticks=500,
            job_templates=(
                _T("granite-3-8b", tp=4, dp=2, pp=1, micro_batches=16,
                   span_nodes=2),
            ),
            fixed_schedule=_collective_hang,
        ),
        ScenarioPreset(
            name="flaky_executor",
            description="Ordinary slowdowns but a flaky mitigation executor: "
                        "35% of dispatches fail, 15% time out — exercises "
                        "retry/backoff/rollback/quarantine",
            n_nodes=2, default_jobs=2, max_ticks=500,
            job_templates=(
                _T("yi-9b", tp=1, dp=4, pp=1, micro_batches=32,
                   span_nodes=2),
            ),
            fixed_schedule=_flaky_faults,
            executor_faults=(0.35, 0.15),
        ),
        ScenarioPreset(
            name="failslow_storm",
            description="Fail-slows at fleet rate: a dense sampled schedule "
                        "over a churning multi-job fleet",
            n_nodes=4, default_jobs=6, max_ticks=500, join_spread_ticks=120,
            job_templates=(
                _T("yi-9b", tp=1, dp=4, pp=2, micro_batches=32),
                _T("granite-3-8b", tp=2, dp=2, pp=1, micro_batches=16,
                   span_nodes=1),
                _T("mistral-nemo-12b", tp=1, dp=8, pp=2, micro_batches=32),
            ),
            fault_model=FaultModel(rate_per_hour=90.0, flap_prob=0.25),
        ),
        ScenarioPreset(
            name="mixed_fleet",
            description="The default evaluation campaign: heterogeneous jobs, "
                        "staggered joins, characterization-mix faults",
            n_nodes=4, default_jobs=8, max_ticks=600, join_spread_ticks=150,
            job_templates=(
                _T("yi-9b", tp=1, dp=4, pp=2, micro_batches=32),
                _T("mistral-nemo-12b", tp=1, dp=8, pp=2, micro_batches=32),
                _T("granite-3-8b", tp=2, dp=2, pp=1, micro_batches=16,
                   span_nodes=1),
                _T("granite-20b", tp=4, dp=2, pp=1, micro_batches=16,
                   span_nodes=2),
            ),
            fault_model=FaultModel(rate_per_hour=22.0),
        ),
    )
}


def list_presets() -> list[str]:
    return list(PRESETS)


def get_preset(name: str) -> ScenarioPreset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
