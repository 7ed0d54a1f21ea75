"""FALCON core: detection (ACF, BOCD, validation) and mitigation (S1-S4)."""

from repro_torch.core.events import (  # noqa: F401
    ChangePoint,
    CommEvent,
    CommOp,
    FailSlowEvent,
    RootCause,
    Strategy,
)
