"""The port's what-if layer (``repro_torch.whatif``) held to the invariants
of ``tests/test_whatif.py`` and to the JAX package's what-if layer.

The replay contract is exactness, so the tests pin bit-equality, not
tolerances, wherever the design promises it: removing every fault
reproduces the healthy run, suppressing every decision reproduces the
faults run, and a default knob bundle reproduces the shipped falcon run.
Attribution reconciliation is pinned on a two-episode toy preset whose
episodes hit disjoint jobs. Every run is on the CPU (``device="cpu"``: the
plain ``torch`` screen in float64), where the port's attribution, Shapley
and tuning artifacts of the toy campaign are the reference's, key for key.
The byte identity of the committed artifacts is
``tests/test_torch_whatif_artifacts.py``.
"""
import json
import os

import pytest
import torch

from repro.cluster.injector import Injection as JInjection
from repro.cluster.injector import InjectionKind as JInjectionKind
from repro.scenarios.campaign import build_campaign as jbuild_campaign
from repro.scenarios.presets import JobTemplate as JJobTemplate
from repro.scenarios.presets import ScenarioPreset as JScenarioPreset
from repro.whatif import WhatIfEngine as JWhatIfEngine
from repro.whatif import decisions_of as jdecisions_of
from repro.whatif import leave_one_out as jleave_one_out
from repro.whatif import shapley as jshapley
from repro.whatif import tune as jtune
from repro_torch.cluster.injector import Injection, InjectionKind
from repro_torch.controlplane import MitigationAction, MitigationResult
from repro_torch.core.events import FailSlowEvent, RootCause, Strategy
from repro_torch.core.planner import KNOB_BOUNDS, MitigationPlanner, PlannerKnobs
from repro_torch.launch import whatif as whatif_cli
from repro_torch.scenarios.campaign import build_campaign, run_campaign
from repro_torch.scenarios.presets import JobTemplate, ScenarioPreset
from repro_torch.scenarios.scoring import run_and_score
from repro_torch.whatif import (
    DecisionRef,
    DecisionScript,
    Variant,
    WhatIfEngine,
    decisions_of,
    leave_one_out,
    shapley,
    tune,
)
from repro_torch.whatif import replay, tuning


def _toy_preset(max_ticks=260, preset_cls=ScenarioPreset, template_cls=JobTemplate,
                injection_cls=Injection, kind=InjectionKind):
    """Two jobs, one clean GPU_SLOW episode each (disjoint slices)."""
    return preset_cls(
        name="toy_whatif",
        description="what-if tier-1: two jobs, one disjoint fault each",
        n_nodes=2, gpus_per_node=4, tick_seconds=5.0, max_ticks=max_ticks,
        default_jobs=2, join_spread_ticks=30,
        job_templates=(
            template_cls("yi-9b", tp=1, dp=2, pp=2, micro_batches=8),
        ),
        fixed_schedule=lambda n_nodes, gpn, dt: [
            injection_cls(100 * dt, 100 * dt, kind.GPU_SLOW, (1,), 0.5),
            injection_cls(120 * dt, 90 * dt, kind.GPU_SLOW, (5,), 0.6),
        ],
    )


def _jax_toy_preset():
    return _toy_preset(preset_cls=JScenarioPreset, template_cls=JJobTemplate,
                       injection_cls=JInjection, kind=JInjectionKind)


def _outcome_tuple(out):
    return (
        out.join_time, out.end_time, out.iters_done, out.steps,
        out.overhead_paid, out.stalled_ticks,
    )


def _dump(obj):
    return json.dumps(obj, indent=1, sort_keys=True)


@pytest.fixture(scope="module")
def toy_engine():
    return WhatIfEngine(
        build_campaign(_toy_preset(), n_jobs=2, seed=0, device="cpu"), device="cpu"
    )


@pytest.fixture(scope="module")
def jax_toy_engine():
    return JWhatIfEngine(jbuild_campaign(_jax_toy_preset(), n_jobs=2, seed=0))


# ------------------------------------------------------ replay invariants
def test_drop_all_faults_reproduces_healthy_bitexact(toy_engine):
    spec = toy_engine.spec
    drop = frozenset(range(len(spec.schedule)))
    dropped = run_campaign(spec, "faults", drop_episodes=drop, device="cpu")
    healthy = toy_engine.baseline["healthy"]
    assert set(dropped.outcomes) == set(healthy.outcomes)
    for job_id, out in healthy.outcomes.items():
        assert _outcome_tuple(dropped.outcomes[job_id]) == _outcome_tuple(out)


def test_suppress_all_decisions_reproduces_faults_bitexact(toy_engine):
    spec = toy_engine.spec
    script = DecisionScript(suppress_all=True)
    suppressed = run_campaign(spec, "falcon", decision_hook=script, device="cpu")
    faults = toy_engine.baseline["faults"]
    for job_id, out in faults.outcomes.items():
        assert _outcome_tuple(suppressed.outcomes[job_id]) == _outcome_tuple(out)
    # The decisions were made and recorded as suppressed, not never-planned.
    assert script.hits
    kinds = {
        ev.kind for ev in suppressed.events
        if isinstance(ev, MitigationResult)
    }
    assert "suppressed" in kinds and "mitigate" not in kinds


def test_default_knobs_reproduce_falcon_bitexact(toy_engine):
    spec = toy_engine.spec
    run = run_campaign(spec, "falcon", planner_knobs=PlannerKnobs(), device="cpu")
    falcon = toy_engine.baseline["falcon"]
    for job_id, out in falcon.outcomes.items():
        assert _outcome_tuple(run.outcomes[job_id]) == _outcome_tuple(out)


def test_faults_replay_only_affected_jobs_is_exact(toy_engine):
    spec = toy_engine.spec
    # Episode 1 touches only j1: dropping it must leave j0's faults
    # outcome byte-identical, via the affected-jobs-only merge.
    variant = Variant(drop_episodes=frozenset({1}))
    assert toy_engine.affected_jobs(frozenset({1})) == ["j1"]
    merged = toy_engine.run_variant("faults", variant)
    full = run_campaign(spec, "faults", drop_episodes={1}, device="cpu")
    for job_id in full.outcomes:
        assert _outcome_tuple(merged.outcomes[job_id]) == _outcome_tuple(
            full.outcomes[job_id]
        )
    # Only one job was re-run for the variant.
    assert toy_engine.stats["variant_job_runs"] <= 1


def test_suppressing_one_decision_is_targeted(toy_engine):
    falcon = toy_engine.baseline["falcon"]
    refs = [d for d in decisions_of(falcon) if d.strategy != "IGNORE"]
    assert refs
    ref = refs[0]
    sup = toy_engine.run_variant("falcon", Variant(suppress=(ref,)))
    horizon = falcon.horizon_s
    # The suppressed job's JCT worsens (or stays); the other job, whose
    # fault is disjoint, keeps its falcon outcome bit-exactly.
    other = [j for j in sup.outcomes if j != ref.job_id]
    for job_id in other:
        assert _outcome_tuple(sup.outcomes[job_id]) == _outcome_tuple(
            falcon.outcomes[job_id]
        )
    assert (
        sup.outcomes[ref.job_id].jct(horizon)
        >= falcon.outcomes[ref.job_id].jct(horizon)
    )


def test_forced_decision_dispatches(toy_engine):
    falcon = toy_engine.baseline["falcon"]
    refs = [d for d in decisions_of(falcon) if d.strategy != "IGNORE"]
    ref = refs[0]
    # Move the decision 10 ticks later: suppress the original, force a
    # copy. The forced dispatch must appear in the event log at >= t.
    moved = DecisionRef(
        job_id=ref.job_id, strategy=ref.strategy, time=ref.time + 50.0
    )
    run = toy_engine.run_variant(
        "falcon", Variant(suppress=(ref,), force=(moved,))
    )
    forced_times = [
        ev.time for ev in run.events
        if isinstance(ev, MitigationAction)
        and ev.job_id == ref.job_id
        and ev.strategy in (Strategy.__members__.get(ref.strategy), ref.strategy)
        and ev.time >= moved.time
    ]
    assert forced_times, "forced decision never dispatched"


# ------------------------------------------------------------ attribution
def test_loo_deltas_reconcile_on_disjoint_episodes(toy_engine):
    att = leave_one_out(toy_engine)
    totals = att["totals"]
    assert totals["gap_s"] > 0
    # Disjoint episodes on disjoint jobs: LOO is exactly additive, the
    # interaction residual must vanish (tolerance = rounding only).
    assert abs(att["per_cause_residual_s"]) < 1e-6 * max(totals["gap_s"], 1.0) + 1e-3
    assert (
        abs(att["per_cause_mitigated_residual_s"])
        < 1e-6 * max(abs(totals["mitigated_s"]), 1.0) + 1e-3
    )
    # Per-decision values reconcile with the total mitigated seconds.
    tol = 0.05 * max(abs(totals["mitigated_s"]), 1.0) + 1e-3
    assert abs(att["per_decision_residual_s"]) <= tol
    assert json.dumps(att, sort_keys=True)  # deterministic artifact shape


def test_loo_is_deterministic(toy_engine):
    a = leave_one_out(toy_engine)
    b = leave_one_out(toy_engine)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    # Second pass is served from the variant cache: no extra replays.
    assert toy_engine.stats["cache_hits"] > 0


def test_shapley_distributes_total_gap(toy_engine):
    sh = shapley(toy_engine, permutations=4)
    assert abs(sh["residual_s"]) < 1e-3
    assert set(sh["per_episode"]) == {"0", "1"}
    total = sum(r["slowdown_s"] for r in sh["per_episode"].values())
    assert total == pytest.approx(sh["total_gap_s"], abs=1e-3)
    for row in sh["per_episode"].values():
        assert row["slowdown_s"] >= 0


# ----------------------------------------------- against the JAX package
def test_toy_attribution_matches_jax(toy_engine, jax_toy_engine):
    """Leave-one-out (per cause and per decision) and Shapley over the
    reference's permutation stream: the same artifact, byte for byte."""
    assert _dump(leave_one_out(toy_engine)) == _dump(jleave_one_out(jax_toy_engine))
    assert _dump(shapley(toy_engine, permutations=3, seed=7)) == \
        _dump(jshapley(jax_toy_engine, permutations=3, seed=7))
    assert [d.key() for d in decisions_of(toy_engine.baseline["falcon"])] == \
        [d.key() for d in jdecisions_of(jax_toy_engine.baseline["falcon"])]


def test_toy_tuning_matches_jax(toy_engine, jax_toy_engine):
    got = tune([toy_engine], knob_names=("prediction_margin",), iters=3)
    want = jtune([jax_toy_engine], knob_names=("prediction_margin",), iters=3)
    assert _dump(got) == _dump(want)


# ----------------------------------------------------------- knob surface
def test_breakeven_scale_scales_thresholds():
    event = FailSlowEvent(
        start_time=0.0, root_cause=RootCause.GPU_DEGRADATION,
        t_healthy=1.0, t_slow=2.0,
    )
    base = MitigationPlanner(event)
    scaled = MitigationPlanner(event, knobs=PlannerKnobs(breakeven_scale=2.0))
    nxt = Strategy.ADJUST_MICROBATCH
    assert scaled._threshold(nxt, 1.0, 10.0) == pytest.approx(
        2.0 * base._threshold(nxt, 1.0, 10.0)
    )
    # The knob bundle overrides the scalar fields.
    assert scaled.breakeven_scale == 2.0
    assert base._threshold(nxt, 1.0, 10.0) == pytest.approx(
        base.overheads[nxt]
    )


def test_knob_bounds_cover_all_knobs():
    assert set(KNOB_BOUNDS) == set(PlannerKnobs().__dataclass_fields__)


def test_tuner_gain_is_non_negative(toy_engine):
    result = tune([toy_engine], knob_names=("breakeven_scale",), iters=4)
    assert result["gain_pct_points"] >= 0.0
    assert result["objective_tuned_pct"] >= result["objective_default_pct"]
    assert result["evaluations"]
    assert json.dumps(result, sort_keys=True)


def test_tune_rejects_an_unknown_knob(toy_engine):
    with pytest.raises(KeyError, match="unknown knob"):
        tune([toy_engine], knob_names=("no_such_knob",))


# ----------------------------------------------------- report round-trip
def test_from_report_roundtrip_and_verification():
    _, _, report = run_and_score("single_gpu_throttle", n_jobs=1, seed=0, device="cpu")
    engine = WhatIfEngine.from_report(report, device="cpu")
    att = leave_one_out(engine)
    # The LOO totals ARE the report's headline number.
    assert att["totals"]["mitigated_pct"] == pytest.approx(
        report["mitigation"]["slowdown_mitigated_pct"], abs=0.01
    )
    # A stale report (different JCTs) must be rejected, not replayed.
    bad = json.loads(json.dumps(report))
    bad["jobs"][0]["jct_s"]["falcon"] += 7.0
    with pytest.raises(ValueError, match="divergence"):
        WhatIfEngine.from_report(bad, device="cpu")
    # So must a report whose decision schedule the rebuild does not make.
    moved = json.loads(json.dumps(report))
    for rec in moved["event_log"]:
        if rec["type"] == "MitigationAction":
            rec["time"] += 5.0
            break
    else:
        pytest.fail("the report holds no MitigationAction")
    with pytest.raises(ValueError, match="decision schedule"):
        WhatIfEngine.from_report(moved, device="cpu")


def test_report_event_log_matches_replayed_decisions():
    _, runs, report = run_and_score("single_gpu_throttle", n_jobs=1, seed=0, device="cpu")
    logged = [
        (e["job_id"], e["strategy"], e["time"])
        for e in report["event_log"]
        if e["type"] == "MitigationAction"
    ]
    replayed = [d.key() for d in decisions_of(runs["falcon"])]
    assert sorted(logged) == sorted(replayed)
    assert json.dumps(report["event_log"], sort_keys=True)


def test_sweep_carries_per_cause_columns():
    from repro_torch.launch.sweep import run_sweep
    sweep = run_sweep("single_gpu_throttle", n_jobs=1, seeds=2, device="cpu")
    table = sweep["per_cause_mitigated_pct"]
    assert "gpu_degradation" in table
    assert table["gpu_degradation"]["n"] == 2
    for row in sweep["per_seed"]:
        assert "per_cause_mitigated_pct" in row
    assert json.dumps(sweep, sort_keys=True)


# ---------------------------------------------------- the device policy
def test_the_device_reaches_every_run(monkeypatch):
    """Every spec build, engine and fresh leg the what-if layer makes is
    handed the engine's device: a run that missed it would go to the card,
    which raises here."""
    seen = []

    def spy(fn, name):
        def wrapped(*args, **kwargs):
            seen.append((name, str(kwargs.get("device"))))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(replay, "build_campaign", spy(replay.build_campaign, "build"))
    monkeypatch.setattr(replay, "run_campaign", spy(replay.run_campaign, "run"))
    engine = WhatIfEngine.from_preset("single_gpu_throttle", device="cpu")
    assert engine.device == torch.device("cpu")
    assert engine._engine().device == torch.device("cpu")
    gid = engine.episodes_by_cause()["gpu_degradation"][0]
    drop = Variant(drop_episodes=frozenset({gid}))
    engine.run_variant("faults", drop)
    engine.run_variant("falcon", drop)
    engine.run_variant("ckpt", drop)
    assert {name for name, _ in seen} == {"build", "run"}
    assert all(dev == "cpu" for _, dev in seen), seen


def test_engines_want_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    spec = build_campaign(_toy_preset(), n_jobs=2, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WhatIfEngine(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WhatIfEngine.from_preset("single_gpu_throttle")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        whatif_cli.main(["--preset", "single_gpu_throttle", "--leave-one-out",
                         "--out", os.devnull])


def test_default_outputs_are_not_results():
    assert tuning.RESULTS_DIR.split(os.sep)[:3] == ["build", "repro_torch_results", "whatif"]
    path = whatif_cli.default_sidecar_path("results/campaigns/mixed_fleet-j8-s0.json")
    assert path == os.path.join("build", "repro_torch_results", "campaigns",
                                "mixed_fleet-j8-s0.attribution.json")
    # explain still reads the committed sidecar beside the baseline report
    assert whatif_cli.sidecar_path("results/campaigns/mixed_fleet-j8-s0.json") == \
        "results/campaigns/mixed_fleet-j8-s0.attribution.json"
