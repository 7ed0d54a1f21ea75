"""FALCON control plane — the public API of the detection/mitigation stack.

    plane = ControlPlane()
    plane.register_job("job0", TrainingSimulator(...), hardware=[...])
    events = plane.tick({"job0": iter_time}, now)   # fleet screening path
    events = plane.observe("job0", iter_time, now)  # exact per-job path

See docs/control_plane.md for the event pipeline, the cluster-adapter
protocol, and how to register a custom mitigation strategy.
"""
from repro_torch.cluster.spec import DirtySet  # noqa: F401  (cursor contract)
from repro_torch.controlplane.adapters import ClusterAdapter, TraceReplayAdapter  # noqa: F401
from repro_torch.controlplane.events import (  # noqa: F401
    ControlEvent,
    Diagnosis,
    Flag,
    Membership,
    MitigationAction,
    MitigationResult,
    Observation,
    ScreenTuning,
    WatchdogAlarm,
    event_log_records,
    event_record,
)
from repro_torch.controlplane.plane import (  # noqa: F401
    ControlPlane,
    ExecutorPolicy,
    JobHandle,
)
from repro_torch.controlplane.strategies import (  # noqa: F401
    AbortReformStrategy,
    CkptRestartStrategy,
    IgnoreStrategy,
    MicroBatchStrategy,
    MitigationContext,
    MitigationStrategy,
    PlacementMicroBatchStrategy,
    PlacementTopologyStrategy,
    StrategyOutcome,
    StrategyRegistry,
    TopologyStrategy,
    default_registry,
    placement_registry,
)
