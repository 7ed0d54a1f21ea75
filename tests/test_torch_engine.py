"""The port's shared-prefix engine (``repro_torch.scenarios.engine``): the
twins of ``tests/test_engine.py``'s fast tests, on the CPU.

Every run the engine serves — recorded completion, snapshot fork, knob
bundle, decision hook — must equal a fresh :func:`run_campaign` execution
at the RunResult level (typed events, per-job outcomes, tick counts). The
port's default screen is the plain ``torch`` step, whose fleet snapshot
keeps one frontier per cohort in the ``"slots"`` layout; the tamper matrix
runs on that layout, and on the reference's fused row layout where the
numpy ``batched`` backend is chosen.
"""
import copy

import numpy as np
import pytest

from repro_torch.core.planner import PlannerKnobs
from repro_torch.scenarios.campaign import MODES, build_campaign, run_campaign
from repro_torch.scenarios.engine import CampaignEngine
from repro_torch.scenarios.presets import PRESETS
from repro_torch.scenarios.scoring import run_and_score, score_campaign

CPU = "cpu"


def _spec(preset, seed=0):
    return build_campaign(preset, seed=seed, device=CPU)


def assert_same_run(fresh, got):
    assert fresh.ticks_run == got.ticks_run
    assert len(fresh.events) == len(got.events)
    for i, (a, b) in enumerate(zip(fresh.events, got.events)):
        assert type(a) is type(b) and a.__dict__ == b.__dict__, (
            f"event {i}: {a!r} != {b!r}"
        )
    assert list(fresh.outcomes) == list(got.outcomes)
    for job_id, a in fresh.outcomes.items():
        b = got.outcomes[job_id]
        for f in ("join_time", "end_time", "iters_done", "steps",
                  "overhead_paid", "stalled_ticks", "mitigations"):
            va, vb = getattr(a, f), getattr(b, f)
            assert va == vb and repr(va) == repr(vb), (job_id, f, va, vb)


def assert_engine_matches_fresh(spec):
    engine = CampaignEngine(spec, device=CPU)
    for mode in MODES:
        assert_same_run(run_campaign(spec, mode, device=CPU), engine.run(mode))
    return engine


# ---------------------------------------------------------------- identity
@pytest.mark.parametrize("preset", [
    "single_gpu_throttle",
    "collective_hang",
    "flaky_executor",
    "mixed_fleet",
])
def test_forked_equals_fresh(preset):
    engine = assert_engine_matches_fresh(_spec(preset))
    assert engine.stats["forked_runs"] + engine.stats["reused_runs"] >= 2


def test_forked_equals_fresh_other_seed():
    assert_engine_matches_fresh(_spec("mixed_fleet", seed=1))


@pytest.mark.slow
@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forked_equals_fresh_all_presets(preset, seed):
    assert_engine_matches_fresh(_spec(preset, seed))


def test_run_and_score_engine_report_matches_fresh():
    _, _, via_engine = run_and_score("collective_hang", seed=0, device=CPU)
    _, _, via_fresh = run_and_score("collective_hang", seed=0, fresh=True,
                                    device=CPU)
    assert via_engine == via_fresh


def test_shared_engine_across_scoring_calls():
    spec = _spec("single_gpu_throttle")
    engine = CampaignEngine(spec, device=CPU)
    _, _, first = run_and_score("single_gpu_throttle", engine=engine)
    _, _, second = run_and_score("single_gpu_throttle", engine=engine)
    assert first == second
    assert engine.stats["memo_hits"] >= 2


def test_engine_snapshots_the_slot_layout_on_the_default_screen():
    engine = CampaignEngine(_spec("mixed_fleet"), device=CPU)
    engine._ensure_base()
    kind, fork = engine._falcon_plan()
    assert kind == "fork"
    fleet = fork.blob["fleet"]
    assert fleet["fused"] is False and fleet["multi"] is None
    batches = [c["batch"] for c in fleet["cohorts"] if c["batch"] is not None]
    assert batches and all(
        tag == "batch" and snap["layout"] == "slots" for tag, snap in batches
    )


# ------------------------------------------------------ per-job divergence
def test_untouched_jobs_ride_the_recording():
    engine = CampaignEngine(_spec("mixed_fleet"), device=CPU)
    faults = engine.run("faults")
    falcon = engine.run("falcon")
    touched = falcon.touched_jobs
    assert touched is not None and touched
    assert touched < set(falcon.outcomes)
    acted = {
        ev.job_id for ev in falcon.events
        if getattr(ev, "job_id", "") and type(ev).__name__ not in
        ("Observation", "ScreenTuning", "Membership")
    }
    assert acted == touched
    for job_id in set(falcon.outcomes) - touched:
        a, b = faults.outcomes[job_id], falcon.outcomes[job_id]
        for f in ("end_time", "iters_done", "stalled_ticks", "overhead_paid"):
            assert repr(getattr(a, f)) == repr(getattr(b, f)), (job_id, f)
        assert not b.mitigations


def test_batched_rng_fast_forward_is_bitwise():
    for k in (1, 7, 304):
        a = np.random.default_rng([0, 7, 3])
        b = np.random.default_rng([0, 7, 3])
        batched = a.normal(1.0, 0.02, size=k)
        scalars = [float(b.normal(1.0, 0.02)) for _ in range(k)]
        assert [repr(float(v)) for v in batched] == [repr(v) for v in scalars]
        assert repr(float(a.normal(1.0, 0.02))) == repr(float(b.normal(1.0, 0.02)))


# ------------------------------------------------- snapshot completeness
class RowEngine(CampaignEngine):
    """The engine with the numpy ``batched`` screen, whose fused frontier
    snapshots in the reference's row layout."""

    def _fleet_kwargs(self, mode):
        return {**super()._fleet_kwargs(mode), "backend": "batched"}


LAYOUTS = {
    "slots": (CampaignEngine, {}),
    "rows": (RowEngine, {"screening_backend": "batched"}),
}


_BASES: dict = {}


def _tampered_branch(layout, preset, mutate):
    """The fresh falcon run, and the falcon branch forked from a copy of
    the engine's fork whose snapshot ``mutate(blob)`` corrupted. The engine's
    recorded legs and the fresh run are shared across the matrix."""
    key = (layout, preset)
    if key not in _BASES:
        engine_cls, fresh_kw = LAYOUTS[layout]
        spec = _spec(preset)
        engine = engine_cls(spec, device=CPU)
        engine._ensure_base()
        kind, fork = engine._falcon_plan()
        assert kind == "fork" and fork is not None
        fresh = run_campaign(spec, "falcon", device=CPU, **fresh_kw)
        _BASES[key] = (engine, fork, fresh)
    engine, fork, fresh = _BASES[key]
    fork = copy.deepcopy(fork)
    mutate(fork.blob)
    return fresh, engine._full_leg("falcon", fork=fork)


def _runs_differ(a, b):
    if a.ticks_run != b.ticks_run or len(a.events) != len(b.events):
        return True
    if any(
        type(x) is not type(y) or x.__dict__ != y.__dict__
        for x, y in zip(a.events, b.events)
    ):
        return True
    return any(
        repr(a.outcomes[j].iters_done) != repr(b.outcomes[j].iters_done)
        or a.outcomes[j].end_time != b.outcomes[j].end_time
        for j in a.outcomes
    )


def _swap_fleet_cols(blob):
    (ja, sa), (jb, sb) = list(blob["jobs"].items())[:2]
    sa["_fleet_col"], sb["_fleet_col"] = sb["_fleet_col"], sa["_fleet_col"]


def _reverse_frontier(blob):
    """Reverse every screened stream's run-length posterior over its
    hypotheses: in the fused row frontier, or in each cohort's slot
    snapshot."""
    fleet = blob["fleet"]
    if fleet["multi"] is not None:
        fleet["multi"]["log_r"] = fleet["multi"]["log_r"][::-1].copy()
        return
    for cohort in fleet["cohorts"]:
        if cohort["batch"] is not None:
            tag, snap = cohort["batch"]
            assert tag == "batch" and snap["layout"] == "slots"
            snap["log_r"] = snap["log_r"][::-1].copy()


TAMPERS = [
    ("fleet-screen sample history", "mixed_fleet",
     lambda blob: blob["fleet"].__setitem__(
         "history",
         (blob["fleet"]["history"][0] * 1.5, blob["fleet"]["history"][1]))),
    ("fleet drift baseline (ewma)", "mixed_fleet",
     lambda blob: blob["fleet"].__setitem__(
         "ewma", blob["fleet"]["ewma"] * 3.0)),
    ("watchdog cadence", "collective_hang",
     lambda blob: blob["watchdog"]["last"].update(
         {j: t - 100.0 for j, t in blob["watchdog"]["last"].items()})),
    ("per-job screen routing", "mixed_fleet", _swap_fleet_cols),
    ("incident-gap counters", "mixed_fleet",
     lambda blob: blob.__setitem__("watched_s", 0.0)),
    ("screen frontier (run-length posterior)", "mixed_fleet", _reverse_frontier),
]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("surface,preset,mutate", TAMPERS,
                         ids=[t[0] for t in TAMPERS])
def test_tampered_snapshot_changes_the_branch(layout, surface, preset, mutate):
    fresh, tampered = _tampered_branch(layout, preset, mutate)
    assert _runs_differ(fresh, tampered), (
        f"corrupting the {surface} snapshot ({layout} layout) did not change "
        "the branch"
    )


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_untampered_fork_blob_roundtrips(layout):
    fresh, branch = _tampered_branch(layout, "mixed_fleet", lambda blob: None)
    assert not _runs_differ(fresh, branch)
    assert_same_run(fresh, branch)


# ------------------------------------------------------------------ memo
def test_memo_identical_knobs_return_cached_run():
    engine = CampaignEngine(_spec("single_gpu_throttle"), device=CPU)
    knobs = PlannerKnobs(breakeven_scale=1.3)
    first = engine.run("falcon", planner_knobs=knobs)
    again = engine.run("falcon", planner_knobs=knobs)
    assert again is first
    assert engine.stats["memo_hits"] == 1
    base = engine.run("falcon")
    assert engine.run("falcon", planner_knobs=PlannerKnobs()) is base


def test_memo_decision_trace_serves_equivalent_knobs():
    spec = _spec("mixed_fleet")
    engine = CampaignEngine(spec, device=CPU)
    engine.run("falcon")
    near = PlannerKnobs(breakeven_scale=1.0 + 1e-9)
    served = engine.run("falcon", planner_knobs=near)
    assert engine.stats["trace_hits"] == 1
    assert_same_run(
        run_campaign(spec, "falcon", planner_knobs=near, device=CPU), served
    )


def test_memo_distinct_decisions_run_fresh():
    spec = _spec("mixed_fleet")
    engine = CampaignEngine(spec, device=CPU)
    base = engine.run("falcon")
    harsh_knobs = PlannerKnobs(breakeven_scale=25.0)
    harsh = engine.run("falcon", planner_knobs=harsh_knobs)
    assert engine.stats["trace_hits"] == 0
    assert _runs_differ(base, harsh)
    assert_same_run(
        run_campaign(spec, "falcon", planner_knobs=harsh_knobs, device=CPU),
        harsh,
    )


def test_decision_hooks_fork_but_never_memoize():
    class Suppress:
        def __init__(self, jobs):
            self.jobs = jobs

        def allow(self, job_id, strategy, now):
            return job_id not in self.jobs

        def allow_relief(self, job_id, now):
            return True

        def forced(self, job_id, now):
            return []

    spec = _spec("mixed_fleet")
    engine = CampaignEngine(spec, device=CPU)
    touched = engine.run("falcon").touched_jobs
    victim = sorted(touched)[0]
    fresh = run_campaign(spec, "falcon", decision_hook=Suppress({victim}),
                         device=CPU)
    got = engine.run("falcon", decision_hook=Suppress({victim}))
    assert_same_run(fresh, got)
    assert engine._memo.keys() == {("falcon", PlannerKnobs())}


# ------------------------------------------------------------- reporting
def test_scored_report_identical_from_engine_runs():
    spec = _spec("flaky_executor")
    engine = CampaignEngine(spec, device=CPU)
    runs_fresh = {m: run_campaign(spec, m, device=CPU) for m in MODES}
    runs_eng = {m: engine.run(m) for m in MODES}
    assert score_campaign(spec, runs_fresh) == score_campaign(spec, runs_eng)
