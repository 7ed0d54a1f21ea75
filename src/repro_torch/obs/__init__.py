"""Observability layer of the port: the per-collective decomposition the
simulator and the control plane attach to every onset diagnosis."""
from repro_torch.obs.collectives import (  # noqa: F401
    COMPONENTS,
    CollectiveBreakdown,
    decompose,
    timing_decomposition,
)
