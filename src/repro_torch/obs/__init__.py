"""Fleet observability layer of the port — tracing, decomposition, metrics,
dashboards; the twin of the reference's ``obs`` package (its account is
docs/observability.md).

* :mod:`repro_torch.obs.tracer` — :class:`SpanTracer`, a simulated-clock span
  recorder exported as Chrome trace-event JSON (``<name>.trace.json``,
  Perfetto-loadable, byte-deterministic). Thread one through
  :class:`~repro_torch.controlplane.ControlPlane` (``tracer=``) and
  :func:`~repro_torch.scenarios.campaign.run_campaign` to see tick cadence,
  watchdog silence windows, executor attempt/retry cycles, and per-job
  fault episodes as nested spans.
* :mod:`repro_torch.obs.collectives` — :class:`CollectiveBreakdown` +
  :func:`decompose`: an iteration's critical path split into
  compute / TP-allreduce / PP-p2p / DP-allreduce with the bottleneck
  collective, profiling group and ring edge named. Attached to every
  onset Diagnosis by the control plane.
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry`
  (counters/gauges/histograms), snapshotted to ``<name>.metrics.json``.
* :mod:`repro_torch.obs.recorder` / :mod:`repro_torch.obs.dashboard` — feed
  the registry from a campaign's typed event pipeline, and render static
  deterministic HTML/SVG dashboards off the serialized event log
  (``python -m repro_torch.launch.obs``). These two sit *above* the control
  plane and scenarios layers, so they are imported explicitly
  (``from repro_torch.obs import recorder``), not re-exported here — this
  package ``__init__`` must stay a leaf (the cluster simulator imports
  :mod:`repro_torch.obs.collectives`).

* :mod:`repro_torch.obs.runtime` — host-clock spans inside the trainer,
  the train step, ``ControlPlane.observe`` and the serve loop, on while a
  ``torch.profiler`` profile is active (then ``user_annotation`` events in
  its trace, over the kernels) or inside ``runtime.recording()``; off they
  cost a flag check. Imported explicitly (``from repro_torch.obs import
  runtime``): it loads torch.

Everything else here is pure Python on the simulated clock: nothing reads
a device or a wall clock. ``runtime`` alone reads the host clock and, on a
card, CUDA events.
"""
from repro_torch.obs.collectives import (  # noqa: F401
    COMPONENTS,
    CollectiveBreakdown,
    decompose,
    timing_decomposition,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.tracer import SpanTracer, TraceError  # noqa: F401
