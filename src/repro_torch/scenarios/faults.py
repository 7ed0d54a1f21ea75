"""Characterization-driven fail-slow fault model (paper §3).

Samples seeded :class:`~repro_torch.cluster.injector.Injection` schedules whose
population statistics follow the characterization study:

* **Cause mix** — computation (GPU degradation, host/CPU contention) vs
  communication (link and NIC congestion) occurrence shares (Table 1; the
  communication share dominates at fleet scale).
* **Durations** — log-uniform from tens of seconds to ~10 hours, matching
  the heavy-tailed duration CDF (Fig. 1): most episodes are minutes, a
  long tail lasts hours.
* **Severity tiers** — weak/medium/severe ~= 20 %/50 %/80 % performance
  loss, the paper's injection tiers, with per-episode jitter.
* **Ramped onsets** — a fraction of network episodes build up gradually
  (congestion accumulates), the shape fixed-offset window detectors miss.
* **Recurring flappers** — some faults relapse: the same component repeats
  its episode a few times with gaps (§3's recurring fail-slows).

Targets are sampled in *global fleet coordinates* (device index / node
index on the shared hardware map); the campaign runner translates each
episode into the local coordinates of every job it lands on, which is how
one host fault hits all co-located jobs at once.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from repro_torch.cluster.injector import Injection, InjectionKind
from repro_torch.core.events import RootCause

#: fault-model cause name -> injection kind
CAUSE_KINDS: dict[str, InjectionKind] = {
    "gpu": InjectionKind.GPU_SLOW,
    "cpu": InjectionKind.CPU_CONTENTION,
    "link": InjectionKind.LINK_CONGESTION,
    "nic": InjectionKind.NIC_CONGESTION,
    "gpu_hang": InjectionKind.GPU_HANG,
    "collective_hang": InjectionKind.COLLECTIVE_HANG,
}

#: injection kind -> the root cause a correct diagnosis reports (scoring)
KIND_CAUSE: dict[InjectionKind, RootCause] = {
    InjectionKind.GPU_SLOW: RootCause.GPU_DEGRADATION,
    InjectionKind.CPU_CONTENTION: RootCause.CPU_CONTENTION,
    InjectionKind.LINK_CONGESTION: RootCause.NETWORK_CONGESTION,
    InjectionKind.NIC_CONGESTION: RootCause.NETWORK_CONGESTION,
    InjectionKind.GPU_HANG: RootCause.GPU_DEGRADATION,
    InjectionKind.COLLECTIVE_HANG: RootCause.NETWORK_CONGESTION,
}

#: the paper's injection tiers: fraction of performance lost
SEVERITY_TIERS: dict[str, float] = {"weak": 0.2, "medium": 0.5, "severe": 0.8}


@dataclass(frozen=True)
class FaultModel:
    """Seeded sampler of fleet-level fail-slow schedules (§3 statistics)."""

    #: fleet-wide fail-slow arrival rate (episodes per hour)
    rate_per_hour: float = 12.0
    #: occurrence share per cause (normalized at sample time)
    cause_mix: tuple[tuple[str, float], ...] = (
        ("gpu", 0.30), ("cpu", 0.20), ("link", 0.30), ("nic", 0.20),
    )
    #: log-uniform episode duration range in seconds (tens of s .. ~10 h)
    duration_range_s: tuple[float, float] = (20.0, 36_000.0)
    #: weak/medium/severe tier weights (normalized at sample time)
    tier_weights: tuple[tuple[str, float], ...] = (
        ("weak", 0.25), ("medium", 0.45), ("severe", 0.30),
    )
    #: uniform jitter added to the tier's base severity
    severity_jitter: float = 0.05
    #: probability that a network episode (link/NIC) has a ramped onset
    ramp_prob: float = 0.5
    #: ramp length as a fraction of the episode duration
    ramp_frac: tuple[float, float] = (0.1, 0.4)
    #: probability a sampled episode is a *hang* instead of a slowdown
    #: (near-infinite multiplier; compute episodes become GPU_HANG,
    #: communication episodes COLLECTIVE_HANG). Every rng draw the hang
    #: path makes is guarded behind this knob, so schedules of presets
    #: with ``hang_prob == 0`` are bit-identical to before it existed.
    hang_prob: float = 0.0
    #: probability an episode is a flapper (recurs on the same component)
    flap_prob: float = 0.15
    #: how many relapses a flapper produces (inclusive integer range)
    flap_repeats: tuple[int, int] = (1, 3)
    #: first occurrences start within this fraction of the horizon
    start_window: float = 0.75

    # ------------------------------------------------------------------
    def sample_schedule(
        self,
        rng: np.random.Generator,
        n_nodes: int,
        gpus_per_node: int,
        horizon_s: float,
    ) -> list[Injection]:
        """One seeded fleet schedule over ``[0, horizon_s)`` seconds."""
        n_devices = n_nodes * gpus_per_node
        causes, cause_w = zip(*self.cause_mix)
        cause_p = np.asarray(cause_w, dtype=np.float64)
        cause_p /= cause_p.sum()
        tiers, tier_w = zip(*self.tier_weights)
        tier_p = np.asarray(tier_w, dtype=np.float64)
        tier_p /= tier_p.sum()
        lo, hi = self.duration_range_s

        out: list[Injection] = []
        n_events = int(rng.poisson(self.rate_per_hour * horizon_s / 3600.0))
        for _ in range(n_events):
            cause = str(rng.choice(causes, p=cause_p))
            kind = CAUSE_KINDS[cause]
            if kind is InjectionKind.LINK_CONGESTION and n_devices < 2:
                kind = InjectionKind.GPU_SLOW  # a 1-device fleet has no links
            start = float(rng.uniform(0.0, self.start_window * horizon_s))
            duration = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            tier = str(rng.choice(tiers, p=tier_p))
            severity = float(np.clip(
                SEVERITY_TIERS[tier]
                + rng.uniform(-self.severity_jitter, self.severity_jitter),
                0.08, 0.92,
            ))
            target = self._sample_target(rng, kind, n_nodes, gpus_per_node)
            ramp = 0.0
            if (
                kind in (InjectionKind.LINK_CONGESTION,
                         InjectionKind.NIC_CONGESTION)
                and rng.random() < self.ramp_prob
            ):
                ramp = duration * float(rng.uniform(*self.ramp_frac))
            episode = Injection(
                start=start, duration=duration, kind=kind, target=target,
                severity=severity, ramp=ramp,
            )
            if self.hang_prob > 0.0 and rng.random() < self.hang_prob:
                comm = kind in (InjectionKind.LINK_CONGESTION,
                                InjectionKind.NIC_CONGESTION)
                hang_kind = (
                    InjectionKind.COLLECTIVE_HANG
                    if comm and n_devices >= 2
                    else InjectionKind.GPU_HANG
                )
                hang_target = (
                    target
                    if kind is InjectionKind.LINK_CONGESTION
                    and hang_kind is InjectionKind.COLLECTIVE_HANG
                    else self._sample_target(
                        rng, hang_kind, n_nodes, gpus_per_node
                    )
                )
                episode = Injection(
                    start=start, duration=duration, kind=hang_kind,
                    target=hang_target, severity=1.0,
                    scope="dp" if hang_kind is InjectionKind.COLLECTIVE_HANG
                    else "",
                )
            out.append(episode)
            if rng.random() < self.flap_prob:
                out += self._flap(rng, episode)
        out.sort(key=lambda i: (i.start, i.kind.value, i.target))
        # Drop whatever starts beyond the horizon (flapper tails).
        return [i for i in out if i.start < horizon_s]

    # ------------------------------------------------------------------
    def _sample_target(
        self,
        rng: np.random.Generator,
        kind: InjectionKind,
        n_nodes: int,
        gpus_per_node: int,
    ) -> tuple[int, ...]:
        n_devices = n_nodes * gpus_per_node
        if kind in (InjectionKind.GPU_SLOW, InjectionKind.GPU_HANG):
            return (int(rng.integers(n_devices)),)
        if kind in (InjectionKind.CPU_CONTENTION, InjectionKind.NIC_CONGESTION):
            return (int(rng.integers(n_nodes)),)
        # Link congestion: one inter-node path (the paper's side-channel
        # bandwidth contention hits RDMA flows).
        a = int(rng.integers(n_devices))
        if n_nodes <= 1:
            b = int(rng.integers(gpus_per_node))
            while b == a:
                b = int(rng.integers(gpus_per_node))
            return (a, b)
        other = [n for n in range(n_nodes) if n != a // gpus_per_node]
        node_b = int(rng.choice(other))
        b = node_b * gpus_per_node + int(rng.integers(gpus_per_node))
        return (a, b)

    def _flap(
        self, rng: np.random.Generator, first: Injection
    ) -> list[Injection]:
        """Relapses of ``first`` on the same component, with gaps."""
        out: list[Injection] = []
        cursor = first.end
        for _ in range(int(rng.integers(self.flap_repeats[0],
                                        self.flap_repeats[1] + 1))):
            gap = first.duration * float(rng.uniform(0.5, 1.5))
            duration = first.duration * float(rng.uniform(0.5, 1.5))
            severity = float(np.clip(
                first.severity
                + rng.uniform(-self.severity_jitter, self.severity_jitter),
                0.08, 0.92,
            ))
            out.append(Injection(
                start=cursor + gap, duration=duration, kind=first.kind,
                target=first.target, severity=severity, ramp=first.ramp,
            ))
            cursor = out[-1].end
        return out


class ExecutorFaultModel:
    """Seeded flaky-executor fault injection: mitigations themselves fail.

    A callable matching the control plane's ``executor_faults`` protocol —
    ``(job_id, strategy, attempt, now) -> None | "fail" | "timeout"`` —
    that makes strategy dispatches flakily fail or time out with the given
    per-attempt probabilities, so campaigns can score the executor's
    retry/backoff/rollback/quarantine machinery. Draws come from a private
    seeded generator consumed in dispatch order, which is deterministic
    per (preset, seed) run; build a fresh instance per campaign mode so
    modes do not share a draw stream. S1 (IGNORE) never faults: it is pure
    bookkeeping with no mechanism to fail (and no rng draw is consumed, so
    its exemption cannot shift later verdicts).
    """

    def __init__(
        self, fail_prob: float = 0.0, timeout_prob: float = 0.0, seed: int = 0
    ) -> None:
        self.fail_prob = float(fail_prob)
        self.timeout_prob = float(timeout_prob)
        self.seed = int(seed)
        self._rng = np.random.default_rng([self.seed, 0xEC5])
        self.calls = 0

    def __call__(
        self, job_id: str, strategy, attempt: int, now: float
    ) -> str | None:
        from repro_torch.core.events import Strategy

        if strategy is Strategy.IGNORE:
            return None
        if self.fail_prob <= 0.0 and self.timeout_prob <= 0.0:
            return None
        self.calls += 1
        u = float(self._rng.random())
        if u < self.fail_prob:
            return "fail"
        if u < self.fail_prob + self.timeout_prob:
            return "timeout"
        return None

    # -- state capture (campaign fork/restore contract) ----------------
    def snapshot(self) -> dict:
        """Draw-stream position as a private copy (the generator state is
        a nested dict; deep-copy keeps forks independent)."""
        return {
            "rng": copy.deepcopy(self._rng.bit_generator.state),
            "calls": self.calls,
        }

    def restore(self, snap: dict) -> None:
        self._rng.bit_generator.state = copy.deepcopy(snap["rng"])
        self.calls = snap["calls"]
