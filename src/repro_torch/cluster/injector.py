"""Deterministic fail-slow injection (paper §7.1).

The paper injects computation fail-slows by locking GPU SM frequency
(`nvidia-smi -lgc`) and communication fail-slows with side-channel bandwidth
contention. Here the same injections are applied to the simulator's
:class:`ClusterState`: compute multipliers for GPU degradation, host
multipliers for CPU contention (hits every GPU on the node), and link
bandwidth multipliers for congestion.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from repro_torch.cluster.spec import ClusterState


class InjectionKind(enum.Enum):
    GPU_SLOW = "gpu_slow"  # one device's SMs throttled
    CPU_CONTENTION = "cpu_contention"  # whole node slowed
    LINK_CONGESTION = "link_congestion"  # one physical link degraded
    NIC_CONGESTION = "nic_congestion"  # a node's NIC port congested
    GPU_HANG = "gpu_hang"  # a device stops making progress (hardware)
    COLLECTIVE_HANG = "collective_hang"  # a collective stuck on a link


#: hang kinds keep the math finite: instead of an infinite multiplier, a
#: hung component runs at this fraction of its healthy speed (~10⁶× slow),
#: far past any throttle — the simulator's stall test keys off the ratio.
HANG_EPS = 1e-6

#: the hang fault family (near-infinite slowdown; severity is metadata)
HANG_KINDS = frozenset({InjectionKind.GPU_HANG, InjectionKind.COLLECTIVE_HANG})


@dataclass(frozen=True)
class Injection:
    """One fail-slow episode.

    ``severity`` in (0, 1): fraction of performance lost. A GPU_SLOW of 0.3
    runs the GPU at 70 % speed; LINK_CONGESTION of 0.75 leaves 25 % of the
    bandwidth (the paper's weak/medium/severe ~= 0.2/0.5/0.8). ``ramp`` > 0
    builds the severity up linearly over that many seconds from onset —
    network congestion typically has a gradual onset (§3), the failure mode
    fixed-offset window detectors miss.

    Hang kinds (``GPU_HANG`` / ``COLLECTIVE_HANG``) ignore ``severity`` and
    ``ramp``: the affected component drops to :data:`HANG_EPS` of its speed
    for the whole episode (a hang has no partial tier and no gradual onset).
    ``scope`` optionally names the collective a ``COLLECTIVE_HANG`` is stuck
    in ("dp" / "tp" / "pp"); it is diagnostic metadata only.
    """

    start: float  # wall-clock seconds
    duration: float
    kind: InjectionKind
    target: tuple[int, ...]  # (device,) / (node,) / (devA, devB)
    severity: float
    ramp: float = 0.0  # seconds from onset to full severity (0 = step)
    scope: str = ""  # optional collective scope for hangs ("dp"/"tp"/"pp")

    @property
    def end(self) -> float:
        return self.start + self.duration

    def active(self, now: float) -> bool:
        return self.start <= now < self.end

    def severity_at(self, now: float) -> float:
        """Effective severity at ``now`` (0 outside the episode)."""
        if not self.active(now):
            return 0.0
        if self.ramp <= 0.0:
            return self.severity
        return self.severity * min(1.0, (now - self.start) / self.ramp)


@dataclass
class FailSlowInjector:
    """Applies the set of active injections to a ClusterState at time t.

    Schedule mutation contract: change ``injections`` only through
    :meth:`add` / :meth:`extend` or by *reassigning the whole list* (the
    S4 restart-clearing pattern, ``injector.injections = [...]``) — all
    three bump ``epoch``, which schedule consumers (the campaign runner's
    per-job fault cursors) rely on to detect staleness. Mutating the list
    in place (``injections.append(...)``) bypasses the epoch and those
    consumers will silently never re-apply.
    """

    injections: list[Injection] = field(default_factory=list)
    _last_applied: tuple | None = field(init=False, default=None)
    #: last-applied per-component multipliers, keyed by
    #: ("c", dev) / ("h", dev) / ("l", (lo, hi)) / ("n", node)
    _applied_vals: dict | None = field(init=False, default=None, repr=False)

    def __setattr__(self, name: str, value) -> None:
        object.__setattr__(self, name, value)
        if name == "injections":
            # Schedule identity epoch: consumers holding a cursor over this
            # injector (campaign per-job fault cursors) must re-apply after
            # any wholesale reassignment — S4 clears active episodes this
            # way when a restart escapes onto healthy hardware.
            d = self.__dict__
            d["epoch"] = d.get("epoch", 0) + 1

    def add(self, inj: Injection) -> None:
        self.injections.append(inj)
        self.epoch += 1

    def extend(self, injections: list[Injection]) -> "FailSlowInjector":
        """Compose another schedule onto this injector (campaign layering:
        a preset's fixed episodes plus a sampled fault-model schedule)."""
        self.injections.extend(injections)
        self.epoch += 1
        return self

    def active(self, now: float) -> list[Injection]:
        return [i for i in self.injections if i.active(now)]

    def _target_values(
        self, state: ClusterState, act: list[Injection], severities
    ) -> dict:
        """Composed per-component multipliers of the active set.

        Multiplication runs in episode order, exactly the chain the
        sequential ``*=`` reapply used to produce — overlapping episodes on
        one target compose (two 0.5-severity GPU throttles leave 25 % of
        the speed), and when the earlier episode ends the later one's
        degradation, not full health, is what remains.
        """
        vals: dict = {}
        per = state.spec.gpus_per_node
        for inj, severity in zip(act, severities):
            mult = HANG_EPS if inj.kind in HANG_KINDS else 1.0 - severity
            if inj.kind in (InjectionKind.GPU_SLOW, InjectionKind.GPU_HANG):
                (dev,) = inj.target
                k = ("c", dev)
                vals[k] = vals.get(k, 1.0) * mult
            elif inj.kind is InjectionKind.CPU_CONTENTION:
                (node,) = inj.target
                for d in range(node * per, (node + 1) * per):
                    k = ("h", d)
                    vals[k] = vals.get(k, 1.0) * mult
            elif inj.kind is InjectionKind.NIC_CONGESTION:
                (node,) = inj.target
                k = ("n", node)
                vals[k] = vals.get(k, 1.0) * mult
            else:
                a, b = inj.target
                k = ("l", (min(a, b), max(a, b)))
                vals[k] = vals.get(k, 1.0) * mult
        return vals

    @staticmethod
    def _write(state: ClusterState, k, v: float) -> None:
        kind, ident = k
        if kind == "c":
            state.devices[ident].compute_speed = v
        elif kind == "h":
            state.devices[ident].host_speed = v
        elif kind == "n":
            state.nic_mult[ident] = v
        else:
            state.link_mult[ident] = v

    @staticmethod
    def _restore(state: ClusterState, k) -> None:
        kind, ident = k
        if kind == "c":
            state.devices[ident].compute_speed = 1.0
        elif kind == "h":
            state.devices[ident].host_speed = 1.0
        elif kind == "n":
            state.nic_mult.pop(ident, None)
        else:
            state.link_mult.pop(ident, None)

    def apply(self, state: ClusterState, now: float) -> list[Injection]:
        """Bring ``state`` to the set of injections active at ``now``.

        Steady state is O(1): when the active set and its effective
        severities are unchanged since the last apply *and* nobody else
        mutated the state (checked through its version counter), nothing is
        touched and the simulator's memoized iteration time survives.

        On a transition (an episode starting, ending, or ramping), the new
        per-component target multipliers are *diffed* against what this
        injector last wrote: only components whose value actually changed
        are written (and components whose episodes all ended are restored),
        so the state's mutation log — and therefore the simulator's
        incremental recompute — stays scoped to the event instead of a
        whole-state reset+reapply. If anyone else mutated the state since
        our last apply, the diff basis is void and the pre-refactor
        reset+reapply runs (same final multipliers either way, since the
        diff writes the identical composed products).
        """
        act = self.active(now)
        severities = tuple(i.severity_at(now) for i in act)
        key = (id(state), tuple(act), severities, state.version)
        if self._last_applied == key:
            return act
        new_vals = self._target_values(state, act, severities)
        prev = self._applied_vals
        if (
            prev is not None
            and self._last_applied is not None
            and self._last_applied[0] == id(state)
            and self._last_applied[3] == state.version
        ):
            # Diff basis valid: the state is exactly what we last wrote.
            for k in prev.keys() - new_vals.keys():
                self._restore(state, k)
            for k, v in new_vals.items():
                if prev.get(k) != v:
                    self._write(state, k, v)
        else:
            state.reset()
            for k, v in new_vals.items():
                self._write(state, k, v)
        self._applied_vals = new_vals
        self._last_applied = (id(state), tuple(act), severities, state.version)
        return act


def sample_injections(
    rng: np.random.Generator,
    n_devices: int,
    gpus_per_node: int,
    horizon: float,
    *,
    p_gpu: float = 0.005,
    p_cpu: float = 0.01,
    p_link: float = 0.4,
    mean_comp_duration: float = 600.0,
    mean_comm_duration: float = 1440.0,
) -> list[Injection]:
    """Sample a fail-slow workload matching the characterization stats (§3):

    computation fail-slows are rare and short (mean ~10 min), communication
    fail-slows (congestion) frequent and long (mean ~24 min); probabilities
    are per-job occurrence rates from Table 1.
    """
    out: list[Injection] = []
    if rng.random() < p_gpu:
        dev = int(rng.integers(n_devices))
        out.append(
            Injection(
                start=float(rng.uniform(0, horizon)),
                duration=float(rng.exponential(mean_comp_duration)),
                kind=InjectionKind.GPU_SLOW,
                target=(dev,),
                severity=float(rng.uniform(0.15, 0.5)),
            )
        )
    if rng.random() < p_cpu:
        node = int(rng.integers(max(1, n_devices // gpus_per_node)))
        out.append(
            Injection(
                start=float(rng.uniform(0, horizon)),
                duration=float(rng.exponential(mean_comp_duration)),
                kind=InjectionKind.CPU_CONTENTION,
                target=(node,),
                severity=float(rng.uniform(0.1, 0.3)),
            )
        )
    if n_devices > gpus_per_node and rng.random() < p_link:
        a = int(rng.integers(n_devices))
        other_nodes = [
            n for n in range(n_devices // gpus_per_node) if n != a // gpus_per_node
        ]
        node_b = int(rng.choice(other_nodes))
        b = node_b * gpus_per_node + int(rng.integers(gpus_per_node))
        out.append(
            Injection(
                start=float(rng.uniform(0, horizon)),
                duration=float(rng.exponential(mean_comm_duration)),
                kind=InjectionKind.LINK_CONGESTION,
                target=(a, b),
                severity=float(rng.uniform(0.3, 0.85)),
            )
        )
    return out
