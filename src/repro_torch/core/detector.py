"""FALCON-DETECT — tracking, profiling, validation (paper §4).

The three-phase workflow:

1. *Tracking*: per-worker iteration times (ACF over the comm-event log) are
   scanned online with BOCD; candidate change-points pass a +/-10 %
   verification step to reject jitter (BOCD+V).
2. *Profiling*: per-communication-group transfer times are compared; groups
   slower than 1.1x the median are *suspicious*.
3. *Validation*: training is briefly paused (the trainer simply withholds
   the next step) and suspicious groups run GEMM compute benchmarks and the
   O(1) ring/tree link sweep to pinpoint slow GPUs / congested links.

The detector talks to the system under test through the small
:class:`ClusterInterface` protocol so it works identically against the real
JAX trainer and the cluster simulator (R1, framework-agnostic).

Fleet fast path: :class:`FleetDetect` screens thousands of worker streams
per tick with one :class:`repro_torch.core.bocd.BatchedBOCD` (a bounded shared
hypothesis frontier keeps the per-tick cost flat) and escalates only flagged
workers to the exact per-worker verification used here. Per-worker history
lives in bounded ring buffers — an observation is O(1), never O(n) in the
stream length.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol

import numpy as np

from repro_torch.core import bocd, validation
from repro_torch.core.events import ChangePoint, FailSlowEvent, RootCause
from repro_torch.core.ringbuf import MatrixRingBuffer, RingBuffer

VERIFY_THRESHOLD = 0.10  # <10 % before/after difference => jitter (§4.2)
SUSPICIOUS_FACTOR = 1.1  # >1.1x median transfer time => suspicious (§4.3)
SLOW_COMPONENT_FACTOR = 1.3  # benchmark time vs median => flagged


class ClusterInterface(Protocol):
    """What FALCON-DETECT needs from the system under test."""

    def profile_groups(self) -> dict[str, float]:
        """Per-communication-group mean transfer time (profiling phase)."""
        ...

    def group_ranks(self, group: str) -> list[int]:
        """Ranks participating in a communication group."""
        ...

    def benchmark_compute(self, ranks: list[int]) -> dict[int, float]:
        """GEMM benchmark time per rank (validation phase)."""
        ...

    def measure_link(self, pair: tuple[int, int]) -> float:
        """P2P transfer time for one link (validation phase)."""
        ...

    def healthy_link_time(self, pair: tuple[int, int]) -> float:
        """Expected healthy P2P time for the link's class (NVLink vs PCIe vs
        RDMA) — the benchmark executor knows the fabric topology."""
        ...


def verify_change_points(
    series: np.ndarray,
    indices: list[int],
    window: int = 10,
    threshold: float = VERIFY_THRESHOLD,
) -> list[ChangePoint]:
    """Change-point verification (§4.2): drop <10 % before/after deltas."""
    x = np.asarray(series, dtype=np.float64)
    out: list[ChangePoint] = []
    for idx in indices:
        lo = max(0, idx - window)
        hi = min(x.size, idx + window)
        if idx - lo < 2 or hi - idx < 2:
            continue
        before = float(np.mean(x[lo:idx]))
        after = float(np.mean(x[idx:hi]))
        if before <= 0:
            continue
        rel = abs(after - before) / before
        if rel >= threshold:
            out.append(
                ChangePoint(
                    index=idx,
                    probability=1.0,
                    mean_before=before,
                    mean_after=after,
                )
            )
    return out


def _verify_windows(
    before_win: np.ndarray,
    after_win: np.ndarray,
    idx: int,
    threshold: float,
) -> ChangePoint | None:
    """The +/-10 % rule over extracted before/after windows (single source
    of truth for both the per-job and the fleet escalation paths)."""
    if before_win.size < 2 or after_win.size < 2:
        return None
    before = float(np.mean(before_win))
    after = float(np.mean(after_win))
    if before <= 0 or abs(after - before) / before < threshold:
        return None
    return ChangePoint(
        index=idx, probability=1.0, mean_before=before, mean_after=after
    )


def _verify_ring(
    series: RingBuffer,
    idx: int,
    window: int,
    threshold: float = VERIFY_THRESHOLD,
) -> ChangePoint | None:
    """:func:`verify_change_points` against a bounded ring buffer.

    Reads only the +/-``window`` slice around the candidate (absolute index
    ``idx``), so verification cost is independent of the stream length.
    Candidates older than the buffer's retention cannot be verified and are
    dropped — with any sane ``history_cap`` BOCD flags changes within a few
    steps of onset, far inside retention.
    """
    n = len(series)
    lo = max(0, idx - window, series.start)
    hi = min(n, idx + window)
    return _verify_windows(
        series.view(lo, idx), series.view(idx, hi), idx, threshold
    )


def detect_slow_iterations(
    iteration_times: np.ndarray,
    hazard: float = 1.0 / 100.0,
    cp_threshold: float = bocd.DEFAULT_CP_THRESHOLD,
    verify_threshold: float = VERIFY_THRESHOLD,
    verify_windows: tuple[int, ...] = (5, 10, 30),
) -> list[ChangePoint]:
    """BOCD + verification over an iteration-time series (offline helper).

    Verification is multi-scale: a change-point is confirmed if the
    before/after means differ by >=10 % at ANY window scale — short windows
    catch brief transients; wide windows catch gradual (ramped) onsets whose
    local slope never reaches the threshold.
    """
    idx = bocd.detect_change_points(
        iteration_times, hazard=hazard, cp_threshold=cp_threshold
    )
    confirmed: dict[int, ChangePoint] = {}
    for w in verify_windows:
        for cp in verify_change_points(
            iteration_times, idx, window=w, threshold=verify_threshold
        ):
            confirmed.setdefault(cp.index, cp)
    return [confirmed[i] for i in sorted(confirmed)]


def detect_slow_iterations_sliding_window(
    iteration_times: np.ndarray,
    window: int = 10,
    threshold: float = VERIFY_THRESHOLD,
) -> list[ChangePoint]:
    """Baseline detector (paper §7.2): flag a >10 % change of the current
    sliding-window mean vs the preceding window's median. Used only for the
    detection-accuracy comparison."""
    x = np.asarray(iteration_times, dtype=np.float64)
    out: list[ChangePoint] = []
    state_slow = False
    for i in range(2 * window, x.size):
        med = float(np.median(x[i - 2 * window : i - window]))
        cur = float(np.mean(x[i - window : i]))
        if med <= 0:
            continue
        rel = (cur - med) / med
        if not state_slow and rel > threshold:
            out.append(
                ChangePoint(index=i, probability=1.0, mean_before=med, mean_after=cur)
            )
            state_slow = True
        elif state_slow and abs(rel) < threshold / 2:
            state_slow = False
    return out


class _ScalarView:
    """Scalar facade over a one-column batched screening backend, so
    :class:`FalconDetect` can run any registry backend on its single
    stream through the scalar ``float -> float`` interface."""

    def __init__(self, backend: bocd.ScreeningBackend) -> None:
        self._b = backend

    def update(self, x: float) -> float:
        return float(self._b.update(np.array([x], dtype=np.float64))[0])

    def p_recent_change(self, window: int = 2) -> float:
        return float(self._b.p_recent_change(window)[0])

    def map_runlength(self) -> int:
        return int(self._b.map_runlength()[0])

    def retune(self, hazard: float | None = None,
               max_hypotheses: int | None = None) -> None:
        self._b.retune(hazard=hazard, max_hypotheses=max_hypotheses)


@dataclass
class FalconDetect:
    """Online detector: feed iteration times, get pinpointed fail-slows."""

    cluster: ClusterInterface
    hazard: float = 1.0 / 100.0
    cp_threshold: float = bocd.DEFAULT_CP_THRESHOLD
    verify_window: int = 10
    #: while an event is active, re-run the O(1) component validation every
    #: this many iterations. Needed because successful mitigation (S2/S3)
    #: flattens the iteration-time signal: the *fault's* relief no longer
    #: shows up as a change-point, only re-validation can see it.
    revalidate_every: int = 10
    #: screening backend for the per-job stream: ``"scalar"`` (the exact
    #: per-series recursion, the default) or any registry name / factory
    #: from :mod:`repro_torch.core.bocd` — non-scalar backends run one-column
    #: batched state behind a scalar facade.
    backend: object = "scalar"
    #: torch device for the ``torch``/``cuda`` backends (None = the card,
    #: raising when there is none — see :mod:`repro_torch.device`)
    device: object = None

    warmup: int = 8
    #: retained iteration-time samples. Only trailing windows are ever read
    #: (jitter scale at warmup, +/-verify_window around a candidate), so a
    #: bounded ring keeps observe() O(1) instead of O(n) per step.
    history_cap: int = 512

    _series: RingBuffer = field(init=False)
    _bocd: object | None = field(init=False, default=None)
    _scale: float = field(init=False, default=1.0)
    _healthy: float = field(init=False, default=0.0)
    active_event: FailSlowEvent | None = field(init=False, default=None)
    history: list[FailSlowEvent] = field(init=False, default_factory=list)

    def __post_init__(self) -> None:
        self._series = RingBuffer(
            max(self.history_cap, self.warmup, 4 * self.verify_window)
        )

    # ------------------------------------------------------------------
    def observe(self, iter_time: float, now: float) -> FailSlowEvent | None:
        """Feed one iteration time; returns a new FailSlowEvent on onset."""
        self._series.append(iter_time)
        n = len(self._series)
        if self._bocd is None:
            # Warm up: estimate the jitter scale from the first samples,
            # then replay them into a freshly-parameterized detector.
            if n < self.warmup:
                return None
            warm = self._series.view(0, n)
            self._scale = bocd.noise_scale(warm)
            factory = bocd.resolve_screening_backend(
                self.backend, device=self.device
            )
            if factory.name == "scalar":
                # Exact per-series recursion, no facade indirection.
                self._bocd = bocd.BOCD(
                    hazard=self.hazard,
                    cp_threshold=self.cp_threshold,
                    mu0=float(warm[0]) / self._scale,
                    beta0=1.0,
                )
            else:
                self._bocd = _ScalarView(factory.make(
                    1,
                    hazard=self.hazard,
                    cp_threshold=self.cp_threshold,
                    mu0=float(warm[0]) / self._scale,
                    beta0=1.0,
                ))
            for v in warm[:-1]:
                self._bocd.update(float(v) / self._scale)
        self._bocd.update(iter_time / self._scale)
        if (
            self.active_event is not None
            and self.active_event.components
            and n % self.revalidate_every == 0
        ):
            had_active = self.active_event
            event = self.revalidate(now, iter_time=iter_time, index=n - 1)
            if event is not None:
                return event
            if self.active_event is not had_active:
                return None  # closed on recovery
        if n < 3 or self._bocd.p_recent_change() <= self.cp_threshold:
            return None
        cp_idx = max(1, n - 1 - self._bocd.map_runlength())
        cp = _verify_ring(
            self._series, cp_idx, window=self.verify_window,
            threshold=VERIFY_THRESHOLD,
        )
        if cp is None:
            return None
        return self.ingest_changepoint(cp, now)

    # ------------------------------------------------------------------
    def ingest_changepoint(
        self, cp: ChangePoint, now: float
    ) -> FailSlowEvent | None:
        """Onset / compound / relief state machine over one *verified*
        change-point.

        This is the escalation entry point the fleet screen routes into
        (:class:`repro_torch.controlplane.ControlPlane`): ``FleetDetect`` verifies
        the change-point cheaply against the worker's history ring, then this
        method runs the full profiling + validation pinpoint exactly as the
        per-job ``observe`` path would.
        """
        if cp.relative_change > 0:
            if self.active_event is None:
                # Onset of a fail-slow: run profiling + validation.
                self._healthy = cp.mean_before
                event = self._pinpoint(now, cp)
                self.active_event = event
                return event
            # Compound fail-slow (paper Fig. 6/17): a second degradation on
            # top of an active one. Close the old event and re-pinpoint —
            # the caller starts a fresh mitigation ladder for the new state.
            if cp.mean_after > 1.05 * self.active_event.t_slow:
                self._close(now)
                event = self._pinpoint(now, cp)
                event.t_healthy = self._healthy or cp.mean_before
                self.active_event = event
                return event
            return None
        if cp.relative_change < 0 and self.active_event is not None:
            # A drop in iteration time can be the fault's relief OR the
            # effect of our own mitigation: when the slow components are
            # known, confirm with the O(1) re-validation before closing.
            if self.active_event.components and not self.components_recovered(
                self.active_event
            ):
                return None
            self._close(now)
        return None

    def revalidate(
        self, now: float, iter_time: float | None = None, index: int = -1
    ) -> FailSlowEvent | None:
        """Re-run the O(1) component validation of the active event.

        Closes the event when its components measure healthy again (needed
        because successful mitigation flattens the iteration-time signal —
        only re-validation can see the fault's relief). When ``iter_time``
        is supplied and is >1.15x the event's recorded severity, the fault
        persists AND got worse: a compound fail-slow piled on (paper
        Fig. 6) — close the stale event, re-pinpoint, and return the new
        event so the caller restarts the mitigation ladder.
        """
        if self.active_event is None or not self.active_event.components:
            return None
        if self.components_recovered(self.active_event):
            self._close(now)
            return None
        if iter_time is not None and iter_time > 1.15 * self.active_event.t_slow:
            stale = self.active_event
            self._close(now)
            cp = ChangePoint(
                index=index,
                probability=1.0,
                mean_before=self._healthy or stale.t_healthy,
                mean_after=iter_time,
            )
            event = self._pinpoint(now, cp)
            event.t_healthy = cp.mean_before
            self.active_event = event
            return event
        return None

    def adopt_event(self, event: FailSlowEvent, now: float) -> FailSlowEvent:
        """Install an externally produced diagnosis as this job's active
        event without re-running profiling + validation (cross-job dedupe:
        another job sharing the hardware already pinpointed the fault)."""
        if self.active_event is not None:
            self._close(now)
        if event.t_healthy > 0:
            self._healthy = event.t_healthy
        self.active_event = event
        return event

    def _close(self, now: float) -> None:
        self.active_event.end_time = now
        self.history.append(self.active_event)
        self.active_event = None

    # ------------------------------------------------------------------
    def components_recovered(self, event: FailSlowEvent) -> bool:
        """Cheap re-validation of the flagged components only (O(1))."""
        ref_link = getattr(self.cluster, "healthy_link_time", None)
        ref_gemm = getattr(self.cluster, "healthy_compute_time", None)
        for comp in event.components:
            kind, _, ident = comp.partition(":")
            if kind == "gpu":
                r = int(ident)
                t = self.cluster.benchmark_compute([r]).get(r)
                if t is None:
                    return False
                if ref_gemm is not None and t > SLOW_COMPONENT_FACTOR * ref_gemm():
                    return False
            elif kind == "link":
                a, b = (int(x) for x in ident.split("-"))
                t = self.cluster.measure_link((a, b))
                if ref_link is not None and t > 1.5 * ref_link((a, b)):
                    return False
            elif kind == "node":
                bench = getattr(self.cluster, "benchmark_host", None)
                ref = getattr(self.cluster, "healthy_host_time", None)
                if bench is None or ref is None:
                    continue  # node comps only come from adapters that have it
                nd = int(ident)
                t = bench([nd]).get(nd)
                if t is None or t > SLOW_COMPONENT_FACTOR * ref():
                    return False
            elif kind == "nic":
                meas = getattr(self.cluster, "measure_nic", None)
                ref = getattr(self.cluster, "healthy_nic_time", None)
                if meas is None or ref is None:
                    continue
                if meas(int(ident)) > 1.5 * ref():
                    return False
        return True

    # ------------------------------------------------------------------
    def _pinpoint(self, now: float, cp: ChangePoint) -> FailSlowEvent:
        """Profiling + validation phases (§4.3).

        The validation sweeps are batched: one ``benchmark_compute`` call
        covers every suspicious group's ranks and one ``measure_links`` /
        ``healthy_link_times`` call (when the adapter provides the batch
        methods) covers every group's ring passes, with the per-group
        median/threshold math done as array ops — the flagging rules are
        unchanged from the per-group loop this replaces.
        """
        group_times = self.cluster.profile_groups()
        suspicious = suspicious_groups(group_times)
        if not suspicious:
            # No group stands out relative to the median — either the
            # degradation is uniform (host-level) or there are too few
            # groups to compare. Validate everything (still cheap: GEMMs in
            # parallel + O(1) link passes per group).
            suspicious = list(group_times)

        group_ranks = [self.cluster.group_ranks(g) for g in suspicious]
        slow_gpus = self._validate_compute(group_ranks)
        slow_links, pair_list, slow_mask = self._validate_links(group_ranks)
        slow_nics = self._nic_components(pair_list, slow_mask)
        slow_hosts: list[str] = []
        if not slow_gpus and not slow_links:
            slow_hosts = self._validate_hosts(group_ranks)

        if slow_gpus and slow_links:
            cause = RootCause.UNKNOWN  # compound; planner treats as generic
        elif slow_gpus:
            cause = RootCause.GPU_DEGRADATION
        elif slow_links:
            cause = RootCause.NETWORK_CONGESTION
        else:
            # Uniform slowdown with healthy GPUs and links points at the host
            # (paper case study 1: CPU contention shows no GPU degradation).
            # When the adapter exposes a host benchmark, the slow node(s) are
            # pinpointed so co-located jobs can dedupe the diagnosis.
            cause = RootCause.CPU_CONTENTION

        severity = 0.0
        if cp.mean_after > 0:
            severity = max(0.0, 1.0 - cp.mean_before / cp.mean_after)
        return FailSlowEvent(
            start_time=now,
            root_cause=cause,
            components=slow_gpus + slow_links + slow_nics + slow_hosts,
            t_healthy=cp.mean_before,
            t_slow=cp.mean_after,
            severity=severity,
        )

    # ------------------------------------------------------------------
    def _validate_hosts(self, group_ranks: list[list[int]]) -> list[str]:
        """Host validation: CPU benchmarks on the nodes spanned by the
        suspicious groups (paper case study 1 — a host-level fault shows
        healthy GPUs and links but a degraded CPU-side benchmark). Requires
        the ``node_of_rank`` / ``benchmark_host`` / ``healthy_host_time``
        adapter surface; adapters without it (e.g. scalar trace replay)
        yield the component-less CPU_CONTENTION diagnosis as before.
        """
        node_of = getattr(self.cluster, "node_of_rank", None)
        bench = getattr(self.cluster, "benchmark_host", None)
        ref = getattr(self.cluster, "healthy_host_time", None)
        if node_of is None or bench is None or ref is None:
            return []
        nodes = sorted({node_of(r) for ranks in group_ranks for r in ranks})
        if not nodes:
            return []
        times = bench(nodes)
        healthy = ref()
        return [
            f"node:{k}" for k in nodes
            if times.get(k, 0.0) > SLOW_COMPONENT_FACTOR * healthy
        ]

    def _nic_components(
        self, pair_list: list[tuple[int, int]], slow_mask: np.ndarray
    ) -> list[str]:
        """Cluster slow inter-node links by NIC port (node-scoped dedupe).

        A congested NIC degrades *every* inter-node flow of its node, so a
        node whose measured inter-node pairs are all slow — at least two
        distinct ones, ruling out a single bad cable — is flagged as
        ``nic:<node>``. Needs ``node_of_rank``; the per-link components are
        kept alongside (mitigation still routes around individual links).
        """
        node_of = getattr(self.cluster, "node_of_rank", None)
        if node_of is None or not pair_list:
            return []
        slow: dict[int, set] = {}
        total: dict[int, set] = {}
        for (a, b), is_slow in zip(pair_list, slow_mask, strict=True):
            na, nb = node_of(a), node_of(b)
            if na == nb:
                continue
            key = (min(a, b), max(a, b))
            for nd in (na, nb):
                total.setdefault(nd, set()).add(key)
                if is_slow:
                    slow.setdefault(nd, set()).add(key)
        return [
            f"nic:{nd}"
            for nd in sorted(total)
            if len(slow.get(nd, ())) >= 2 and slow[nd] == total[nd]
        ]

    # ------------------------------------------------------------------
    def _validate_compute(self, group_ranks: list[list[int]]) -> list[str]:
        """Computation validation (parallel GEMM), batched over groups.

        One ``benchmark_compute`` call covers the union of all groups'
        ranks; a rank is flagged per group against that group's median, so
        results (order and duplicates included) match the former
        one-call-per-group loop.
        """
        all_ranks: list[int] = []
        seen: set[int] = set()
        for ranks in group_ranks:
            for r in ranks:
                if r not in seen:
                    seen.add(r)
                    all_ranks.append(r)
        comp = self.cluster.benchmark_compute(all_ranks) if all_ranks else {}
        if not comp:
            return []
        # Bucket groups by size so each bucket's medians/thresholds are one
        # vectorized pass; bucket order preserves first-appearance order.
        buckets: dict[int, list[int]] = {}
        for gi, ranks in enumerate(group_ranks):
            sub = [r for r in ranks if r in comp]
            if sub:
                buckets.setdefault(len(sub), []).append(gi)
        flags: list[list[str]] = [[] for _ in group_ranks]
        for size, gis in buckets.items():
            mat = np.array(
                [[comp[r] for r in group_ranks[gi] if r in comp] for gi in gis],
                dtype=np.float64,
            )
            med = np.median(mat, axis=1)
            mask = mat > SLOW_COMPONENT_FACTOR * med[:, None]
            for row, gi in enumerate(gis):
                sub = [r for r in group_ranks[gi] if r in comp]
                flags[gi] = [f"gpu:{sub[j]}" for j in np.flatnonzero(mask[row])]
        return [f for per_group in flags for f in per_group]

    def _validate_links(
        self, group_ranks: list[list[int]]
    ) -> tuple[list[str], list[tuple[int, int]], np.ndarray]:
        """Communication validation (O(1) ring sweep), batched over groups.

        All groups' pass-schedule pairs are measured in one
        ``measure_links`` / ``healthy_link_times`` adapter call when
        available (falling back to per-pair scalars otherwise); the slow
        rule is then applied per group exactly as
        :func:`repro_torch.core.validation.validate_links` does. Returns the slow
        components plus the raw (pair, slow) sweep so the caller can cluster
        link faults by NIC port.
        """
        pair_list: list[tuple[int, int]] = []
        slices: list[tuple[int, int]] = []  # [start, end) into pair_list
        for ranks in group_ranks:
            start = len(pair_list)
            if len(ranks) >= 2:
                for p in validation.ring_passes(len(ranks)):
                    pair_list += [(ranks[a], ranks[b]) for a, b in p]
            slices.append((start, len(pair_list)))
        if not pair_list:
            return [], [], np.zeros(0, dtype=bool)
        pairs = np.asarray(pair_list, dtype=np.int64)
        measure_many = getattr(self.cluster, "measure_links", None)
        if measure_many is not None:
            t = np.asarray(measure_many(pairs), dtype=np.float64)
        else:
            t = np.array(
                [self.cluster.measure_link((a, b)) for a, b in pair_list]
            )
        reference = getattr(self.cluster, "healthy_link_time", None)
        if reference is not None:
            ref_many = getattr(self.cluster, "healthy_link_times", None)
            if ref_many is not None:
                ref = np.asarray(ref_many(pairs), dtype=np.float64)
            else:
                ref = np.array([reference((a, b)) for a, b in pair_list])
            slow_mask = t > 1.5 * np.maximum(ref, 1e-12)
        else:
            # No healthy reference: each group's own median is the yardstick.
            slow_mask = np.zeros(t.size, dtype=bool)
            for lo, hi in slices:
                if hi > lo:
                    vals = np.sort(t[lo:hi])
                    slow_mask[lo:hi] = t[lo:hi] > 1.5 * vals[(hi - lo) // 2]
        comps = [
            f"link:{a}-{b}"
            for (a, b), slow in zip(pair_list, slow_mask, strict=True)
            if slow
        ]
        return comps, pair_list, slow_mask


@dataclass(frozen=True)
class FleetFlag:
    """One verified change-point on one worker's stream."""

    worker: int
    change_point: ChangePoint


@dataclass
class _Cohort:
    """Workers warmed together share one :class:`~repro_torch.core.bocd.BatchedBOCD`.

    ``cols`` are current column indices into the fleet history matrix (kept
    in ascending order; re-indexed on removals), ``start`` is the absolute
    tick index of the cohort's first sample — its members joined then and
    have no earlier history. ``batch`` stays None while the cohort warms up.
    """

    cols: list[int]
    start: int
    batch: bocd.ScreeningBackend | None = None
    #: cached int64 array form of ``cols`` (membership edits reset it);
    #: the per-tick loops index the history matrix with it
    arr: np.ndarray | None = None

    def cols_array(self) -> np.ndarray:
        if self.arr is None or self.arr.size != len(self.cols):
            self.arr = np.asarray(self.cols, dtype=np.int64)
        return self.arr


@dataclass
class FleetDetect:
    """Fleet-tier screening over thousands of concurrent worker streams.

    One :class:`repro_torch.core.bocd.BatchedBOCD` advances every worker's
    run-length recursion in lockstep per tick; only workers whose recent
    change probability crosses the threshold are escalated to the exact
    per-worker verification (the same +/-10 % rule FalconDetect applies),
    reading that worker's trailing window from a bounded history ring.
    Confirmed flags are returned for the caller to route into the per-job
    pinpoint/validation path (:class:`FalconDetect` against that job's
    cluster interface).

    ``max_hypotheses`` bounds the shared run-length frontier so the per-tick
    cost is flat in stream length; the escalation path re-checks flagged
    workers exactly, so the screen only needs to be sensitive, not precise.

    Dynamic membership (multi-job campaigns with churn): workers
    :meth:`add_worker` / :meth:`remove_worker` at any point. A leave
    sub-slices the owning batch (:meth:`~repro_torch.core.bocd.BatchedBOCD.
    take_columns` — survivors' posteriors carry over exactly). A join opens
    a warming *cohort*: its stream buffers in the history ring until it has
    ``warmup`` samples, then warms its own batch — established workers keep
    their run-length state untouched. :meth:`consolidate` re-warms every
    warmed cohort into one shared frontier by replaying the common retained
    window (from the youngest member's join), equivalent to a fresh
    ``FleetDetect`` fed that window; ``max_cohorts`` triggers it
    automatically so per-tick cost stays one batched update per cohort,
    bounded.
    """

    n_workers: int
    hazard: float = 1.0 / 100.0
    cp_threshold: float = bocd.DEFAULT_CP_THRESHOLD
    verify_threshold: float = VERIFY_THRESHOLD
    verify_window: int = 10
    #: extra verification scales tried after ``verify_window`` (the same
    #: multi-scale rule as :func:`detect_slow_iterations`): short windows
    #: catch brief transients, wide windows catch ramped onsets whose local
    #: slope never crosses the 10 % threshold at one scale
    verify_windows: tuple[int, ...] = (5, 30)
    #: drift screen: BOCD's run-length posterior *tracks* a gradual ramp
    #: (each step is barely surprising, so Pr(r=0) never spikes — congestion
    #: building up over minutes is invisible to the change-point rule). The
    #: complementary screen compares each worker's trailing mean against a
    #: reference window ``drift_ref`` ticks back and escalates when they
    #: differ by the verification threshold; 0 disables it.
    drift_ref: int = 40
    drift_ref_window: int = 10
    drift_cur_window: int = 5
    #: consecutive ticks the drift condition must hold before escalating.
    #: An abrupt step also trips the lagged comparison (the trailing mean
    #: mixes pre/post samples), but BOCD flags it exactly within a tick or
    #: two — the hold gives BOCD first claim so one physical change never
    #: produces both a change-point flag and a sloppier drift flag.
    drift_hold: int = 5
    #: long-horizon screen: the lagged comparison above still misses creeps
    #: slower than threshold over ``drift_ref`` ticks (a 10 %/hour ramp at a
    #: 30 s tick moves ~3 % per 40 ticks). Each stream additionally tracks a
    #: slow EWMA baseline (span ``ewma_span`` ticks); when the trailing mean
    #: departs from it by the verification threshold for ``ewma_hold``
    #: consecutive ticks, the stream is escalated with the baseline as
    #: ``mean_before``. A linear creep of slope ``r``/tick settles at a
    #: ``r * span/2`` gap above the baseline, so the screen catches creeps
    #: down to ``2*threshold/span`` per tick (span 2000, threshold 10 %:
    #: 0.01 %/tick — a 10 %/hour ramp on a 5 s tick is ~0.014 %/tick). The
    #: baseline lives outside the history ring (O(1) memory), so long spans
    #: are free. It re-anchors (and its maturity resets) on *every*
    #: confirmed flag, so step changes stay BOCD's: after any flag the
    #: screen needs ``ewma_min_age`` ticks of fresh baseline before it may
    #: fire again. 0 disables.
    ewma_span: int = 2000
    ewma_min_age: int = 64
    ewma_hold: int = 8
    warmup: int = 8
    min_gap: int = 3
    recent_window: int = 2
    history_cap: int = 128
    max_hypotheses: int | None = 32
    #: auto-consolidate when more than this many cohorts are warmed
    #: (None = never; joins then cost one extra batch each, forever)
    max_cohorts: int | None = 4
    #: adaptive screening knobs: every this many ticks, re-derive the
    #: per-worker hazard (and the shared frontier cap, when one is set)
    #: from the observed confirmed-flag rate instead of trusting the
    #: constructor constants forever — see :meth:`_retune`. 0 keeps the
    #: fixed constants (the default; campaign determinism depends on it).
    adapt_every: int = 0
    hazard_bounds: tuple[float, float] = (1.0 / 20000.0, 1.0 / 20.0)
    cap_bounds: tuple[int, int] = (8, 256)
    #: screening backend: a registry name (``"scalar"`` / ``"batched"`` /
    #: ``"torch"`` / ``"cuda"``), ``"auto"`` (the CUDA kernel on the card,
    #: the plain torch step when ``device`` is the CPU —
    #: :func:`repro_torch.core.bocd.select_backend`), or a
    #: :class:`repro_torch.core.bocd.ScreeningBackendFactory` instance. Passing a
    #: backend *class* (the pre-backend-API style) still works but warns.
    backend: object = "auto"
    #: torch device for the ``torch``/``cuda``/``auto`` backends (None =
    #: the card, raising when there is none); the numpy backends ignore it
    device: object = None
    #: fuse all warmed cohorts into one :class:`repro_torch.core.bocd.MultiBOCD`
    #: frontier so each tick runs ONE batched update instead of one per
    #: cohort (bit-identical per column — see MultiBOCD's contract). Only
    #: takes effect on the vectorized numpy backend; the scalar and torch
    #: backends keep the per-cohort path. Off by default — the campaign
    #: engine (scenarios/engine.py) opts in where the fused frontier's
    #: snapshot/restore support pays for itself.
    fused: bool = False
    #: last re-tune's chosen values (None until the first retune); the
    #: control plane mirrors this into its typed event log as ScreenTuning
    last_tuning: dict | None = field(init=False, default=None)

    _history: MatrixRingBuffer = field(init=False)
    _cohorts: list[_Cohort] = field(init=False)
    _scale: np.ndarray = field(init=False)
    _last_flag: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        self._backend = bocd.resolve_screening_backend(
            self.backend, device=self.device
        )
        self._fused = bool(self.fused) and isinstance(
            self._backend, bocd.BatchedScreening
        )
        self._multi = bocd.MultiBOCD() if self._fused else None
        self._hazard0 = self.hazard
        self._flags_total = 0
        self._worker_ticks = 0
        self._ticks = 0
        # The ring must retain every window any screen reads: the widest
        # verification scale and the drift screen's reference lookback — a
        # smaller user-set history_cap would silently blind those paths.
        lookback = (
            self.drift_ref + self.drift_ref_window if self.drift_ref else 0
        )
        widest = 2 * max((self.verify_window, *self.verify_windows))
        self._history = MatrixRingBuffer(
            max(self.history_cap, self.warmup, 4 * self.verify_window,
                lookback, widest),
            self.n_workers,
        )
        self._scale = np.full(self.n_workers, np.nan)
        self._last_flag = np.full(self.n_workers, -(10**9), dtype=np.int64)
        self._drift_count = np.zeros(self.n_workers, dtype=np.int64)
        self._ewma = np.full(self.n_workers, np.nan)
        self._ewma_age = np.zeros(self.n_workers, dtype=np.int64)
        self._ewma_count = np.zeros(self.n_workers, dtype=np.int64)
        self._cohorts = (
            [_Cohort(cols=list(range(self.n_workers)), start=0)]
            if self.n_workers
            else []
        )

    # -- dynamic membership --------------------------------------------
    @property
    def n_cohorts(self) -> int:
        return len(self._cohorts)

    def add_worker(self) -> int:
        """Register one more stream; returns its column index.

        The worker joins a warming cohort anchored at the current tick:
        screening for it starts once it has ``warmup`` samples, while every
        established cohort's run-length state is left untouched.
        """
        w = self._history.add_column(np.nan)
        self._scale = np.append(self._scale, np.nan)
        self._last_flag = np.append(self._last_flag, -(10**9))
        self._drift_count = np.append(self._drift_count, 0)
        self._ewma = np.append(self._ewma, np.nan)
        self._ewma_age = np.append(self._ewma_age, 0)
        self._ewma_count = np.append(self._ewma_count, 0)
        now = len(self._history)
        if (
            self._cohorts
            and self._cohorts[-1].batch is None
            and self._cohorts[-1].start == now
        ):
            self._cohorts[-1].cols.append(w)  # joined in the same gap
            self._cohorts[-1].arr = None
        else:
            self._cohorts.append(_Cohort(cols=[w], start=now))
        self.n_workers += 1
        return w

    def remove_worker(self, w: int) -> None:
        """Drop one stream; columns above ``w`` shift down by one.

        The owning cohort's batch is column-sub-sliced in place, so the
        surviving members' posteriors (and future flags) are exactly what
        they would have been had the departed stream never been tracked
        (uncapped; under ``max_hypotheses`` the shared frontier may differ).
        """
        self._history.remove_column(w)
        self._scale = np.delete(self._scale, w)
        self._last_flag = np.delete(self._last_flag, w)
        self._drift_count = np.delete(self._drift_count, w)
        self._ewma = np.delete(self._ewma, w)
        self._ewma_age = np.delete(self._ewma_age, w)
        self._ewma_count = np.delete(self._ewma_count, w)
        for cohort in list(self._cohorts):
            if w in cohort.cols:
                if cohort.batch is not None:
                    keep = [i for i, c in enumerate(cohort.cols) if c != w]
                    cohort.batch.take_columns(np.asarray(keep, dtype=np.int64))
                cohort.cols.remove(w)
                if not cohort.cols:
                    self._cohorts.remove(cohort)
                    continue
            cohort.cols = [c - 1 if c > w else c for c in cohort.cols]
            cohort.arr = None
        self.n_workers -= 1

    def consolidate(self) -> None:
        """Re-warm all warmed cohorts into one shared frontier.

        Rebuilds a single :class:`~repro_torch.core.bocd.BatchedBOCD` by replaying
        the retained history window common to every warmed worker (the
        youngest member's join forward): noise scales are re-estimated from
        the window's first ``warmup`` rows, so the result is identical to a
        fresh ``FleetDetect`` fed exactly that window. Run-length memory
        older than the window is forgotten — the escalation path re-verifies
        against the full history ring, so sensitivity to *future* changes is
        what matters. Warming cohorts are left to finish on their own.
        """
        warmed = [c for c in self._cohorts if c.batch is not None]
        if len(warmed) <= 1:
            return
        n = len(self._history)
        start = max(max(c.start for c in warmed), self._history.start)
        if n - start < self.warmup:
            return  # not enough common history to re-estimate scales
        cols = sorted(c for cohort in warmed for c in cohort.cols)
        warm = self._history.rows(start, n)[:, cols]
        scale = bocd.noise_scale_batch(warm[: self.warmup])
        batch = self._backend.make(
            len(cols),
            hazard=self.hazard,
            mu0=warm[0] / scale,
            cp_threshold=self.cp_threshold,
            max_hypotheses=self.max_hypotheses,
        )
        for row in warm:
            batch.update(row / scale)
        self._scale[cols] = scale
        merged = _Cohort(cols=cols, start=start, batch=batch)
        self._cohorts = [merged] + [
            c for c in self._cohorts if c.batch is None
        ]
        if self._fused:
            self._rebuild_multi()

    def _rebuild_multi(self) -> None:
        """Re-absorb every warmed cohort into a fresh fused frontier (after
        consolidation replaced the warmed batches with one standalone)."""
        self._multi = bocd.MultiBOCD()
        for cohort in self._cohorts:
            batch = cohort.batch
            if batch is None:
                continue
            if isinstance(batch, bocd.MultiGroupHandle):
                batch = batch.export()
            cohort.batch = self._multi.absorb(batch)

    # -- snapshot / restore --------------------------------------------
    def snapshot(self) -> dict:
        """Full mutable state as private copies (engine fork support).

        Cohort batches are encoded as ``None`` (warming), a standalone
        backend snapshot, or the index of their group inside the fused
        frontier; backends without snapshot support (scalar fan-out) raise
        so callers can fall back to fresh execution.
        """
        cohorts: list[dict] = []
        group_index: dict[int, int] = {}
        if self._multi is not None:
            group_index = {
                id(g): i for i, g in enumerate(self._multi._groups)
            }
        for cohort in self._cohorts:
            batch: object = None
            if isinstance(cohort.batch, bocd.MultiGroupHandle):
                batch = ("multi", group_index[id(cohort.batch.group)])
            elif cohort.batch is not None:
                if not hasattr(cohort.batch, "snapshot"):
                    raise NotImplementedError(
                        "screening backend "
                        f"{type(cohort.batch).__name__} has no snapshot()"
                    )
                batch = ("batch", cohort.batch.snapshot())
            cohorts.append(
                {"cols": list(cohort.cols), "start": cohort.start,
                 "batch": batch}
            )
        return {
            "fused": self._fused,
            "hazard": self.hazard,
            "max_hypotheses": self.max_hypotheses,
            "adapt_every": self.adapt_every,
            "n_workers": self.n_workers,
            "last_tuning": (
                dict(self.last_tuning) if self.last_tuning else None
            ),
            "flags_total": self._flags_total,
            "worker_ticks": self._worker_ticks,
            "ticks": self._ticks,
            "history": (self._history._data.copy(), self._history._n),
            "scale": self._scale.copy(),
            "last_flag": self._last_flag.copy(),
            "drift_count": self._drift_count.copy(),
            "ewma": self._ewma.copy(),
            "ewma_age": self._ewma_age.copy(),
            "ewma_count": self._ewma_count.copy(),
            "cohorts": cohorts,
            "multi": (
                self._multi.snapshot() if self._multi is not None else None
            ),
        }

    def restore(self, snap: dict) -> None:
        """Reinstate :meth:`snapshot` state; the instance must have been
        built with the same constructor constants (backend, windows,
        thresholds) — only mutable state is carried in the snapshot."""
        if snap["fused"] != self._fused:
            raise ValueError("snapshot fused mode differs from instance")
        self.hazard = snap["hazard"]
        self.max_hypotheses = snap["max_hypotheses"]
        self.adapt_every = snap["adapt_every"]
        self.n_workers = snap["n_workers"]
        self.last_tuning = (
            dict(snap["last_tuning"]) if snap["last_tuning"] else None
        )
        self._flags_total = snap["flags_total"]
        self._worker_ticks = snap["worker_ticks"]
        self._ticks = snap["ticks"]
        data, n_hist = snap["history"]
        self._history._data = data.copy()
        self._history._n = n_hist
        self._scale = snap["scale"].copy()
        self._last_flag = snap["last_flag"].copy()
        self._drift_count = snap["drift_count"].copy()
        self._ewma = snap["ewma"].copy()
        self._ewma_age = snap["ewma_age"].copy()
        self._ewma_count = snap["ewma_count"].copy()
        if snap["multi"] is not None:
            if self._multi is None:
                self._multi = bocd.MultiBOCD()
            self._multi.restore(snap["multi"])
        self._cohorts = []
        for rec in snap["cohorts"]:
            cohort = _Cohort(cols=list(rec["cols"]), start=rec["start"])
            batch = rec["batch"]
            if batch is not None:
                kind, payload = batch
                if kind == "multi":
                    cohort.batch = bocd.MultiGroupHandle(
                        self._multi, self._multi._groups[payload]
                    )
                else:
                    fresh = self._backend.make(
                        len(cohort.cols),
                        hazard=self.hazard,
                        mu0=np.zeros(len(cohort.cols)),
                        cp_threshold=self.cp_threshold,
                        max_hypotheses=self.max_hypotheses,
                    )
                    fresh.restore(payload)
                    cohort.batch = fresh
            self._cohorts.append(cohort)

    # ------------------------------------------------------------------
    def tick(self, times: np.ndarray) -> list[FleetFlag]:
        """Feed one iteration time per worker; returns verified flags."""
        times = np.asarray(times, dtype=np.float64)
        if times.shape != (self.n_workers,):
            raise ValueError(
                f"expected shape ({self.n_workers},), got {times.shape}"
            )
        self._history.append(times)
        n = len(self._history)
        i = n - 1
        if self.ewma_span:
            # Long-horizon baseline: slow EWMA per stream, seeded on the
            # first sample, re-anchored on every confirmed flag.
            fresh = np.isnan(self._ewma)
            if fresh.any():
                self._ewma[fresh] = times[fresh]
            alpha = 2.0 / (self.ewma_span + 1.0)
            self._ewma += alpha * (times - self._ewma)
            self._ewma_age += 1
        out: list[FleetFlag] = []
        if self._fused:
            # Fused pre-pass: warm any ready cohorts into the shared
            # MultiBOCD frontier, then advance every group with ONE fused
            # update instead of one batched update per cohort.
            for cohort in self._cohorts:
                if cohort.batch is None and n - cohort.start >= self.warmup:
                    cohort.batch = self._multi.absorb(
                        self._warm_cohort(cohort, n)
                    )
            if self._multi.n_series:
                x = np.empty(self._multi.n_series)
                for cohort in self._cohorts:
                    if cohort.batch is not None:
                        cols = cohort.cols_array()
                        x[cohort.batch.cols] = (
                            times[cols] / self._scale[cols]
                        )
                self._multi.update(x)
        drift_ref_mean, drift_cur_mean = self._drift_means(n)
        for cohort in self._cohorts:
            cols = cohort.cols_array()
            if cohort.batch is None:
                if n - cohort.start < self.warmup:
                    continue
                cohort.batch = self._warm_cohort(cohort, n)
            if not self._fused:
                cohort.batch.update(times[cols] / self._scale[cols])
            if i - cohort.start <= self.recent_window:
                continue
            p = cohort.batch.p_recent_change(self.recent_window)
            flagged = np.flatnonzero(p > self.cp_threshold)
            if flagged.size:
                run_lengths = cohort.batch.map_runlength()
                for local_w in flagged:
                    w = cohort.cols[int(local_w)]
                    idx = i - int(run_lengths[local_w])
                    if (
                        idx <= cohort.start
                        or idx - self._last_flag[w] < self.min_gap
                    ):
                        continue
                    cp = self._verify(w, idx, n, floor=cohort.start)
                    if cp is not None:
                        # Dedup on *confirmed* flags only: the first
                        # post-onset ticks may lack the 2 after-samples
                        # verification needs, and the detection burst must
                        # be allowed to retry until one sticks.
                        self._last_flag[w] = idx
                        self._anchor(w, cp.mean_after)
                        out.append(FleetFlag(worker=w, change_point=cp))
            out += self._drift_screen(
                cohort, cols, n, drift_ref_mean, drift_cur_mean
            )
        out += self._long_drift_screen(n, drift_cur_mean)
        if (
            self.max_cohorts is not None
            and sum(1 for c in self._cohorts if c.batch is not None)
            > self.max_cohorts
        ):
            self.consolidate()
        self._flags_total += len(out)
        self._worker_ticks += self.n_workers
        self._ticks += 1
        if self.adapt_every and self._ticks % self.adapt_every == 0:
            self._retune()
        return out

    def _warm_cohort(self, cohort: _Cohort, n: int) -> bocd.ScreeningBackend:
        """Warm one cohort: estimate noise scales from its retained window,
        build a standalone batch, and replay every row but the current one
        (the caller feeds that through the per-tick update path)."""
        cols = np.asarray(cohort.cols, dtype=np.int64)
        warm = self._history.rows(cohort.start, n)[:, cols]
        scale = bocd.noise_scale_batch(warm)
        self._scale[cols] = scale
        batch = self._backend.make(
            cols.size,
            hazard=self.hazard,
            mu0=warm[0] / scale,
            cp_threshold=self.cp_threshold,
            max_hypotheses=self.max_hypotheses,
        )
        for row in warm[:-1]:
            batch.update(row / scale)
        return batch

    def _drift_means(
        self, n: int
    ) -> tuple[np.ndarray | None, np.ndarray | None]:
        """Full-width reference/current trailing means for the drift screen,
        computed once per tick and column-sliced per cohort (bit-identical
        to the per-cohort means for cohorts of >= 2 workers; single-worker
        cohorts recompute on the per-cohort shape — see MultiBOCD)."""
        if not self.drift_ref:
            return None, None
        lag_lo = n - self.drift_ref - self.drift_ref_window
        if lag_lo < self._history.start or lag_lo < 0:
            return None, None
        ref = self._history.rows(
            lag_lo, lag_lo + self.drift_ref_window
        ).mean(axis=0)
        cur = self._history.rows(n - self.drift_cur_window, n).mean(axis=0)
        return ref, cur

    def _anchor(self, w: int, level: float) -> None:
        """Re-anchor worker ``w``'s long-horizon baseline at ``level``
        (the verified post-change mean of a confirmed flag) and restart its
        maturity clock — the baseline always describes the level since the
        last confirmed change, so one physical change never fires both a
        change-point flag and a later long-drift flag."""
        if not self.ewma_span:
            return
        self._ewma[w] = level
        self._ewma_age[w] = 0
        self._ewma_count[w] = 0

    def _long_drift_screen(
        self, n: int, cur_full: np.ndarray | None = None
    ) -> list[FleetFlag]:
        """Creep candidates: trailing mean vs the long-horizon EWMA baseline
        (see ``ewma_span``). No local-window verification is possible — a
        slow creep has no step for the ±window rule to see — so the flag's
        change-point carries (baseline, trailing mean) directly and the real
        verification is the escalation path's component validation. On
        firing, the stream's jitter scale is re-estimated from the trailing
        window (it was frozen at warmup, and under drift the old scale
        mis-standardizes the new level's noise) and the baseline re-anchors.
        """
        if not self.ewma_span:
            return []
        i = n - 1
        w = self.drift_cur_window
        lo = n - w
        if lo < self._history.start or lo < 0:
            return []
        # cur_full (from _drift_means) is this exact expression, computed
        # once per tick when the drift screen also ran.
        cur = (
            cur_full
            if cur_full is not None
            else self._history.rows(lo, n).mean(axis=0)
        )
        base = self._ewma
        with np.errstate(invalid="ignore"):
            ok = (
                (self._ewma_age >= self.ewma_min_age)
                & ~np.isnan(cur)
                & (base > 0)
            )
            rel = np.abs(cur - base) / np.maximum(base, 1e-12)
            over = ok & (rel >= self.verify_threshold)
        self._ewma_count[over] += 1
        self._ewma_count[~over] = 0
        out: list[FleetFlag] = []
        for col in np.flatnonzero(over):
            wk = int(col)
            if (
                self._ewma_count[wk] < self.ewma_hold
                or i - self._last_flag[wk] < self.min_gap
            ):
                continue
            idx = i - w + 1
            cp = ChangePoint(
                index=idx,
                probability=1.0,
                mean_before=float(base[wk]),
                mean_after=float(cur[wk]),
            )
            self._last_flag[wk] = idx
            m = min(n - self._history.start, 4 * self.warmup)
            self._scale[wk] = bocd.noise_scale(
                self._history.column(wk, n - m, n)
            )
            self._anchor(wk, float(cur[wk]))
            out.append(FleetFlag(worker=wk, change_point=cp))
        return out

    def _retune(self) -> None:
        """Adaptive screening knobs (see ``adapt_every``): re-derive the
        hazard from the observed confirmed-flag rate (Laplace-smoothed
        toward the constructor prior, so zero evidence keeps it) and size
        the shared run-length frontier to the expected segment length —
        longer quiet segments need deeper run-length memory to stay exact,
        shorter ones don't. Applied to every warmed batch in place; new
        cohorts pick the values up at warmup."""
        rate = self._flags_total / max(self._worker_ticks, 1)
        hazard = (self._flags_total + 1.0) / (
            self._worker_ticks + 1.0 / self._hazard0
        )
        hazard = float(min(max(hazard, self.hazard_bounds[0]),
                           self.hazard_bounds[1]))
        cap = None
        if self.max_hypotheses is not None:
            cap = int(min(max(round(4.0 / hazard ** 0.5), self.cap_bounds[0]),
                          self.cap_bounds[1]))
            self.max_hypotheses = cap
        self.hazard = hazard
        for cohort in self._cohorts:
            if cohort.batch is not None:
                cohort.batch.retune(hazard=hazard, max_hypotheses=cap)
        self.last_tuning = {
            "tick": self._ticks,
            "hazard": hazard,
            "max_hypotheses": cap,
            "change_rate": rate,
            "flags": self._flags_total,
            "worker_ticks": self._worker_ticks,
        }

    def _drift_screen(
        self,
        cohort: _Cohort,
        cols: np.ndarray,
        n: int,
        ref_full: np.ndarray | None = None,
        cur_full: np.ndarray | None = None,
    ) -> list[FleetFlag]:
        """Lagged-window drift candidates for one cohort (see ``drift_ref``).

        One vectorized mean-vs-mean comparison per tick; candidates go
        through the exact multi-scale verification like BOCD flags do, so
        the screen adds sensitivity to gradual onsets without adding a new
        false-positive source.
        """
        if not self.drift_ref:
            return []
        i = n - 1
        lag_lo = n - self.drift_ref - self.drift_ref_window
        if lag_lo < max(cohort.start, self._history.start):
            return []
        if ref_full is not None and cols.size >= 2:
            # Column-slice the precomputed full-width means (bit-identical:
            # numpy's axis-0 reduction is per-column for >= 2 columns). A
            # single-worker cohort reduces on numpy's 1-D pairwise path, so
            # it recomputes on the per-cohort operand below.
            ref = ref_full[cols]
            cur = cur_full[cols]
        else:
            ref = self._history.rows(lag_lo, lag_lo + self.drift_ref_window)[
                :, cols
            ].mean(axis=0)
            cur = self._history.rows(n - self.drift_cur_window, n)[
                :, cols
            ].mean(axis=0)
        rel = np.abs(cur - ref) / np.maximum(ref, 1e-12)
        over = rel >= self.verify_threshold
        self._drift_count[cols[over]] += 1
        self._drift_count[cols[~over]] = 0
        out: list[FleetFlag] = []
        for local_w in np.flatnonzero(over):
            w = cohort.cols[int(local_w)]
            # The reference window must postdate the worker's last confirmed
            # change-point: a drift candidate whose baseline straddles an
            # already-flagged change is that change re-detected against a
            # stale reference, not a new fault.
            if (
                self._drift_count[w] < self.drift_hold
                or lag_lo <= self._last_flag[w]
            ):
                continue
            idx = i - self.drift_cur_window + 1
            cp = self._verify(w, idx, n, floor=cohort.start)
            if cp is not None:
                self._last_flag[w] = idx
                self._anchor(w, cp.mean_after)
                out.append(FleetFlag(worker=w, change_point=cp))
        return out

    def _verify(
        self, worker: int, idx: int, n: int, floor: int = 0
    ) -> ChangePoint | None:
        for w in (self.verify_window, *self.verify_windows):
            lo = max(floor, idx - w, self._history.start)
            hi = min(n, idx + w)
            cp = _verify_windows(
                self._history.column(worker, lo, idx),
                self._history.column(worker, idx, hi),
                idx,
                self.verify_threshold,
            )
            if cp is not None:
                return cp
        return None


def suspicious_groups(
    group_times: dict[str, float], factor: float = SUSPICIOUS_FACTOR
) -> list[str]:
    """Groups with transfer time > factor x median (§4.3 profiling)."""
    if not group_times:
        return []
    med = float(np.median(list(group_times.values())))
    if med <= 0:
        return []
    return [g for g, t in group_times.items() if t > factor * med]


@dataclass
class Watchdog:
    """Missing-observation heartbeat monitor (hang detection).

    BOCD — batched or not — structurally cannot flag a stream that *stops
    emitting samples*: with no new observation the run-length recursion
    simply does not advance. A hang looks exactly like that (the current
    iteration never completes), so hang detection keys off silence, not
    values: every delivered sample is a :meth:`beat`, and :meth:`expired`
    fires once the silence exceeds a deadline calibrated to that stream's
    own inter-arrival jitter,

        deadline = max(floor_gaps * mean_gap, mean_gap + k_sigma * std_gap)

    with mean/std tracked as EWMAs of the observed gaps. A stream that
    always reports on a metronomic cadence gets a tight ``floor_gaps``
    deadline; a stream whose delivery jitters gets proportionally more
    slack, keeping the false-positive rate at zero on healthy-but-noisy
    streams. Nothing fires before ``min_beats`` heartbeats — there is no
    calibrated cadence to miss yet.
    """

    #: minimum deadline, in multiples of the mean inter-arrival gap
    floor_gaps: float = 3.0
    #: jitter slack: deadline stretches this many gap std-devs past the mean
    k_sigma: float = 8.0
    #: heartbeats required before a stream's deadline is armed
    min_beats: int = 2
    #: EWMA smoothing factor for the gap mean/variance
    alpha: float = 0.2

    _last: dict = field(init=False, default_factory=dict)
    _mean: dict = field(init=False, default_factory=dict)
    _var: dict = field(init=False, default_factory=dict)
    _beats: dict = field(init=False, default_factory=dict)

    def beat(self, key, now: float) -> None:
        """Record a delivered observation for stream ``key`` at ``now``."""
        prev = self._last.get(key)
        self._last[key] = now
        self._beats[key] = self._beats.get(key, 0) + 1
        if prev is None:
            return
        gap = now - prev
        dl = self._deadline_gap(key)
        if dl is not None and gap > dl:
            # Resume after a stall (or a delivery outage): folding the
            # silent stretch into the cadence statistics would poison every
            # future deadline, so re-anchor without updating them.
            return
        mean = self._mean.get(key)
        if mean is None:
            self._mean[key] = gap
            self._var[key] = 0.0
            return
        a = self.alpha
        delta = gap - mean
        self._mean[key] = mean + a * delta
        self._var[key] = (1.0 - a) * (self._var[key] + a * delta * delta)

    def _deadline_gap(self, key) -> float | None:
        """Allowed silence in seconds, or None while uncalibrated."""
        mean = self._mean.get(key)
        if mean is None or self._beats.get(key, 0) < self.min_beats:
            return None
        std = float(np.sqrt(max(self._var.get(key, 0.0), 0.0)))
        return max(self.floor_gaps * mean, mean + self.k_sigma * std)

    def deadline(self, key) -> float | None:
        """Public view of the stream's current silence budget (seconds)."""
        return self._deadline_gap(key)

    def silence(self, key, now: float) -> float:
        """Seconds since the stream's last heartbeat (0 if never seen)."""
        last = self._last.get(key)
        return 0.0 if last is None else max(now - last, 0.0)

    def expired(self, key, now: float) -> bool:
        """True when ``key`` has been silent past its calibrated deadline."""
        dl = self._deadline_gap(key)
        return dl is not None and self.silence(key, now) > dl

    def forget(self, key) -> None:
        """Drop all state for a departed stream (job leave)."""
        for d in (self._last, self._mean, self._var, self._beats):
            d.pop(key, None)

    # -- state capture (campaign fork/restore contract) -----------------
    def snapshot(self) -> dict:
        """All cadence state as private copies (keys are job ids: shallow
        dict copies suffice — values are floats/ints)."""
        return {
            "last": dict(self._last),
            "mean": dict(self._mean),
            "var": dict(self._var),
            "beats": dict(self._beats),
        }

    def restore(self, snap: dict) -> None:
        self._last = dict(snap["last"])
        self._mean = dict(snap["mean"])
        self._var = dict(snap["var"])
        self._beats = dict(snap["beats"])
