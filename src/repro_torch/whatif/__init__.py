"""What-if engine: counterfactual replay, attribution, knob auto-tuning —
the twin of the reference's ``whatif`` package.

    engine = WhatIfEngine.from_preset("mixed_fleet", n_jobs=8, seed=0)
    attribution = leave_one_out(engine)      # per-cause / per-decision
    tuned = tune([engine])                   # planner knob auto-tuning

Built on the deterministic campaign runner's replay contract (the
reference's account is docs/whatif.md): a recorded campaign can be re-run
with a fault episode removed, a decision suppressed or forced, or
different planner knobs, and every outcome difference is attributable to
that edit alone. Engines take ``device``: the card by default, where the
fleet screen is the CUDA ``bocd_step`` kernel; ``device="cpu"`` on request.
CLI: ``python -m repro_torch.launch.whatif``.
"""
from repro_torch.whatif.attribution import leave_one_out, shapley  # noqa: F401
from repro_torch.whatif.replay import (  # noqa: F401
    DecisionRef,
    DecisionScript,
    Variant,
    WhatIfEngine,
    decisions_of,
)
from repro_torch.whatif.tuning import (  # noqa: F401
    objective,
    tune,
    tune_knob,
    write_tuning,
)
