"""Labeled iteration-time trace generation for detector benchmarks.

Reproduces the *shape* of the characterization traces (§3): healthy jitter,
occasional single-iteration spikes, and step-like fail-slow episodes whose
onset/relief indices are the ground-truth labels for Tables 4-5.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class LabeledEpisode:
    onset: int  # iteration index of onset
    relief: int  # iteration index of recovery
    severity: float  # relative slowdown, e.g. 0.3 => 1.3x iteration time
    #: iterations over which the slowdown ramps up linearly (0 = step onset;
    #: network congestion typically builds up gradually)
    ramp: int = 0


@dataclass
class LabeledTrace:
    times: np.ndarray
    episodes: list[LabeledEpisode] = field(default_factory=list)

    @property
    def has_failslow(self) -> bool:
        return bool(self.episodes)


def generate_trace(
    rng: np.random.Generator,
    n_iters: int = 600,
    base_time: float = 1.0,
    jitter: float = 0.01,
    spike_prob: float = 0.0005,
    episodes: list[LabeledEpisode] | None = None,
) -> LabeledTrace:
    """One sampling-job trace with the given fail-slow episodes baked in."""
    t = rng.normal(base_time, jitter * base_time, size=n_iters)
    # Occasional one-iteration spikes (dataloader hiccups, GC) — the jitter
    # the verification step must not mistake for fail-slow.
    spikes = rng.random(n_iters) < spike_prob
    t[spikes] *= rng.uniform(1.1, 1.3, size=int(spikes.sum()))
    for ep in episodes or []:
        lo, hi = max(0, ep.onset), min(n_iters, ep.relief)
        mult = np.full(hi - lo, 1.0 + ep.severity)
        if ep.ramp > 0:
            k = min(ep.ramp, hi - lo)
            mult[:k] = 1.0 + ep.severity * np.linspace(1.0 / k, 1.0, k)
        t[lo:hi] *= mult
    return LabeledTrace(times=np.maximum(t, 1e-6), episodes=list(episodes or []))


def episodes_from_injections(
    injections,
    tick_seconds: float,
    n_ticks: int,
) -> list[LabeledEpisode]:
    """Express an injection schedule as labeled episodes in tick space.

    Bridges the two ground-truth vocabularies: the scenario engine samples
    :class:`~repro_torch.cluster.injector.Injection` schedules in wall-clock
    seconds, while the detector benchmarks and the scoring layer label
    traces in iteration/tick indices. Episodes entirely outside the horizon
    are dropped; the rest are clamped to it.
    """
    out: list[LabeledEpisode] = []
    for inj in injections:
        onset = int(inj.start / tick_seconds)
        relief = int(np.ceil(inj.end / tick_seconds))
        if onset >= n_ticks or relief <= 0:
            continue
        out.append(
            LabeledEpisode(
                onset=max(0, onset),
                relief=min(relief, n_ticks),
                severity=float(inj.severity),
                ramp=int(np.ceil(inj.ramp / tick_seconds)),
            )
        )
    return out


def sample_campaign(
    seed: int,
    n_jobs: int,
    failslow_rate: float,
    n_iters: int = 600,
    min_severity: float = 0.12,
    max_severity: float = 0.8,
) -> list[LabeledTrace]:
    """A campaign of sampling jobs, a fraction of which fail slow (§3.2/3.3)."""
    rng = np.random.default_rng(seed)
    traces: list[LabeledTrace] = []
    for _ in range(n_jobs):
        episodes: list[LabeledEpisode] = []
        if rng.random() < failslow_rate:
            n_ep = int(rng.integers(1, 3))
            starts = np.sort(rng.integers(40, n_iters - 80, size=n_ep))
            for s in starts:
                roll = rng.random()
                ramp = 0
                if roll < 0.2:
                    # Short transient episode (tens of seconds in Fig. 1's
                    # duration CDF): only a few iterations long — these are
                    # what dilution-prone window detectors miss.
                    dur = int(rng.integers(4, 9))
                    sev = float(rng.uniform(max(0.2, min_severity), max_severity))
                elif roll < 0.5:
                    # Gradual-onset episode: congestion builds up over tens of
                    # iterations, so no two nearby windows ever differ by the
                    # detection threshold — fixed-offset comparisons miss it.
                    dur = int(rng.integers(60, max(61, n_iters // 3)))
                    sev = float(rng.uniform(max(0.2, min_severity), max_severity))
                    ramp = int(rng.integers(30, 60))
                else:
                    dur = int(rng.integers(30, max(31, n_iters // 3)))
                    sev = float(rng.uniform(min_severity, max_severity))
                episodes.append(
                    LabeledEpisode(
                        onset=int(s),
                        relief=min(int(s) + dur, n_iters - 10),
                        severity=sev,
                        ramp=ramp,
                    )
                )
            # Drop overlapping episodes (keep the first of each overlap).
            pruned: list[LabeledEpisode] = []
            last_end = -10**9
            for ep in episodes:
                if ep.onset > last_end + 20:
                    pruned.append(ep)
                    last_end = ep.relief
            episodes = pruned
        traces.append(generate_trace(rng, n_iters=n_iters, episodes=episodes))
    return traces
