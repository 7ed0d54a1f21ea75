"""Scenario campaign engine — reproduce the paper's *statistical* claims.

The paper's headline numbers (>99 % detection accuracy, 60.1 % slowdown
mitigated, 1.34 % average JCT delay) are fleet-scale statistics over diverse
fail-slow populations, not single hand-wired scenarios. This package makes
them measurable:

* :mod:`repro_torch.scenarios.faults` — a seeded fault model sampling injection
  schedules from the §3 characterization (cause mix, log-spaced durations,
  weak/medium/severe tiers, ramped network onsets, recurring flappers).
* :mod:`repro_torch.scenarios.presets` — named scenario presets, from a single
  GPU throttle to multi-job fail-slow storms.
* :mod:`repro_torch.scenarios.campaign` — the campaign runner: N heterogeneous
  jobs packed onto a shared hardware map, driven through
  :meth:`repro_torch.controlplane.ControlPlane.tick` with dynamic join/leave
  churn, under four mitigation modes (healthy / faults / ckpt / falcon).
* :mod:`repro_torch.scenarios.engine` — the shared-prefix executor: the four
  modes are bit-identical until the control plane first intervenes, so
  :class:`~repro_torch.scenarios.engine.CampaignEngine` records that timeline
  once, forks each plane mode from a snapshot at its divergence point,
  keeps untouched jobs riding the recording, and memoizes knob-bundle
  variants by their decision trace — byte-identical to fresh
  :func:`run_campaign` execution.
* :mod:`repro_torch.scenarios.scoring` — paper-metric scoring from the typed
  event log: per-cause precision/recall/detection latency against the
  ground-truth schedule, %-slowdown mitigated vs the no-mitigation and
  checkpoint-restart baselines, per-job JCT delay. Reports land in
  ``build/repro_torch_results/campaigns/`` and are byte-deterministic in
  (preset, seed).

This is the twin of the reference's ``scenarios`` package (its account is
docs/scenarios.md). Runs take ``device``: the card by default, where the
fleet screen is the CUDA ``bocd_step`` kernel; ``device="cpu"`` on request.

    PYTHONPATH=src python -m repro_torch.launch.campaign --preset mixed_fleet \
        --jobs 8 --seed 0 [--device cpu]
"""
from repro_torch.scenarios.campaign import (  # noqa: F401
    CampaignSpec,
    PlacedJob,
    RunResult,
    build_campaign,
    run_campaign,
)
from repro_torch.scenarios.engine import CampaignEngine  # noqa: F401
from repro_torch.scenarios.faults import (  # noqa: F401
    CAUSE_KINDS,
    KIND_CAUSE,
    SEVERITY_TIERS,
    ExecutorFaultModel,
    FaultModel,
)
from repro_torch.scenarios.presets import (  # noqa: F401
    JobTemplate,
    ScenarioPreset,
    get_preset,
    list_presets,
)
from repro_torch.scenarios.scoring import (  # noqa: F401
    run_and_score,
    score_campaign,
    write_report,
)
