"""Event types shared by the FALCON detection/mitigation stack.

The detection pipeline is framework-agnostic (paper R1): it consumes only
streams of :class:`CommEvent` (what the paper's LD_PRELOAD shim logs) and
emits :class:`FailSlowEvent` descriptions that the mitigation planner acts on.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class CommOp(enum.Enum):
    """Collective-communication operation types the Monitor logs."""

    ALL_REDUCE = "AR"
    ALL_GATHER = "AG"
    REDUCE_SCATTER = "RS"
    ALL_TO_ALL = "A2A"
    SEND_RECV = "P2P"
    BROADCAST = "BC"


class RootCause(enum.Enum):
    """Fail-slow root causes from the characterization study (Table 1)."""

    CPU_CONTENTION = "cpu_contention"
    GPU_DEGRADATION = "gpu_degradation"
    NETWORK_CONGESTION = "network_congestion"
    UNKNOWN = "unknown"


class Strategy(enum.Enum):
    """Mitigation strategies S1-S4 (Table 3), ordered by overhead."""

    IGNORE = 1
    ADJUST_MICROBATCH = 2
    ADJUST_TOPOLOGY = 3
    CKPT_AND_RESTART = 4


#: A mitigation-strategy identifier: the paper's S1-S4 enum members, or a
#: string for strategies registered by users of the control plane (e.g.
#: "HOT_SPARE_SWAP"). The planner and the strategy registry are keyed by
#: this union so new scenarios are one class, not an enum edit.
StrategyKey = Strategy | str


def strategy_label(key: StrategyKey) -> str:
    """Human-readable name of a strategy key (enum member or string)."""
    return key.name if isinstance(key, Strategy) else str(key)


@dataclass(frozen=True)
class CommEvent:
    """One logged communication call: (type, timestamp, group, rank)."""

    op: CommOp
    timestamp: float  # seconds
    group: str = ""  # communication-group id, e.g. "dp0", "tp3"
    rank: int = 0
    duration: float = 0.0  # filled during the profiling phase (CUDA events)


@dataclass
class FailSlowEvent:
    """A detected fail-slow incident, as handed to the mitigation planner."""

    start_time: float
    root_cause: RootCause = RootCause.UNKNOWN
    #: slow component ids, e.g. GPU ranks or "link:3-4"
    components: list[str] = field(default_factory=list)
    #: healthy iteration time (s) measured before onset
    t_healthy: float = 0.0
    #: degraded iteration time (s) during the event
    t_slow: float = 0.0
    #: severity in [0, 1): relative throughput loss
    severity: float = 0.0
    #: True when the incident is a hang (unbounded slowdown): the stream
    #: stopped emitting samples and the watchdog, not BOCD, flagged it.
    #: Hangs take the abort/re-form mitigation path — micro-batch re-splits
    #: and placement swaps cannot unstick a stuck collective.
    hang: bool = False
    end_time: float | None = None  # None while ongoing

    @property
    def resolved(self) -> bool:
        return self.end_time is not None

    def duration(self, now: float) -> float:
        return (self.end_time if self.resolved else now) - self.start_time


@dataclass(frozen=True)
class ChangePoint:
    """A change-point in the iteration-time series (BOCD output)."""

    index: int
    probability: float
    #: mean iteration time before / after the change-point
    mean_before: float = 0.0
    mean_after: float = 0.0

    @property
    def relative_change(self) -> float:
        if self.mean_before <= 0.0:
            return 0.0
        return (self.mean_after - self.mean_before) / self.mean_before
