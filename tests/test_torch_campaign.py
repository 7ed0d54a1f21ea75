"""The port's campaign layer (``repro_torch.scenarios``,
``repro_torch.launch.campaign``) held against the JAX package's.

* Each of the eight committed reports ``results/campaigns/<preset>-j<n>-s0
  .json`` regenerates byte for byte, into a temp dir, through the port's
  CLI with the numpy backends (``--device cpu --screening-backend batched
  --reduction-backend vectorized``: independent runs of the four modes) and
  through ``run_and_score(..., device="cpu")`` with the default backends
  (the shared-prefix engine, the plain ``torch`` screen in float64 and
  ``TorchReduction``).
* ``build_campaign`` gives the reference's spec for the same (preset, jobs,
  seed): placements, quotas, the injection schedule and its per-job
  translations, the probed impacts; the fault models draw the reference's
  random streams.
* The twins of ``tests/test_scenarios.py``'s fast tests.
"""
import dataclasses
import enum
import json
import os

import numpy as np
import pytest
import torch

from repro import scenarios as ref_scenarios
from repro.core import events as ref_events
from repro_torch.cluster.injector import FailSlowInjector, Injection, InjectionKind
from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
from repro_torch.cluster.spec import ClusterSpec, ClusterState, ModelSpec
from repro_torch.controlplane import ControlPlane, Diagnosis
from repro_torch.core import events as port_events
from repro_torch.core.events import FailSlowEvent, RootCause
from repro_torch.launch import campaign as campaign_cli
from repro_torch.scenarios import (
    ExecutorFaultModel,
    FaultModel,
    JobTemplate,
    ScenarioPreset,
    build_campaign,
    run_and_score,
    run_campaign,
    score_campaign,
    write_report,
)
from repro_torch.scenarios.campaign import MODES
from repro_torch.scenarios.presets import PRESETS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGNS = os.path.join(REPO, "results", "campaigns")

#: every committed report: preset -> its default job count
COMMITTED = {
    "single_gpu_throttle": 1,
    "rack_nic_congestion": 4,
    "cascading_host_contention": 4,
    "long_tail_degradation": 2,
    "collective_hang": 2,
    "flaky_executor": 2,
    "failslow_storm": 6,
    "mixed_fleet": 8,
}
MODEL = ModelSpec(layers=32, hidden=4096, seq_len=2048, vocab=32000)


def _committed(preset: str) -> bytes:
    path = os.path.join(CAMPAIGNS, f"{preset}-j{COMMITTED[preset]}-s0.json")
    with open(path, "rb") as f:
        return f.read()


def test_committed_reports_cover_every_preset():
    assert sorted(COMMITTED) == sorted(PRESETS)
    for preset, jobs in COMMITTED.items():
        assert PRESETS[preset].default_jobs == jobs


# -------------------------------------------- byte identity of the reports
@pytest.mark.parametrize("preset", sorted(COMMITTED))
def test_report_byte_identical_through_cli_numpy_backends(preset, tmp_path, capsys):
    campaign_cli.main([
        "--preset", preset, "--seed", "0", "--device", "cpu",
        "--screening-backend", "batched", "--reduction-backend", "vectorized",
        "--out", str(tmp_path), "--quiet",
    ])
    path = tmp_path / f"{preset}-j{COMMITTED[preset]}-s0.json"
    assert f"report: {path}" in capsys.readouterr().out
    assert path.read_bytes() == _committed(preset)


@pytest.mark.parametrize("preset", sorted(COMMITTED))
def test_report_byte_identical_through_auto_on_cpu(preset, tmp_path, monkeypatch):
    from repro_torch.kernels import bocd_step

    # The default route screens with the plain torch step in float64.
    made = []
    init = bocd_step.TorchBOCD.__init__

    def counting_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append((type(self).__name__, self.dtype, self.device.type))

    monkeypatch.setattr(bocd_step.TorchBOCD, "__init__", counting_init)
    spec, runs, report = run_and_score(preset, device="cpu")
    assert set(runs) == set(MODES)
    assert made and set(made) == {("TorchBOCD", torch.float64, "cpu")}
    path = write_report(report, str(tmp_path))
    with open(path, "rb") as f:
        assert f.read() == _committed(preset)


def test_default_output_directory_is_not_results():
    from repro_torch.launch import sweep
    from repro_torch.scenarios import scoring

    for d in (scoring.RESULTS_DIR, sweep.RESULTS_DIR):
        assert d.split(os.sep)[:2] == ["build", "repro_torch_results"], d


# ------------------------------------------------------ the same spec
def _plain(obj):
    """A dataclass tree as plain Python data: enums by value, functions by
    name, tuples as lists — comparable across the two packages."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {_plain(k): _plain(v) for k, v in obj.items()}
    if callable(obj):
        return obj.__name__
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


@pytest.mark.parametrize("preset", sorted(COMMITTED))
def test_build_campaign_gives_the_reference_spec(preset):
    want = ref_scenarios.build_campaign(preset, seed=0)
    got = build_campaign(preset, seed=0, device="cpu")
    a, b = _plain(want), _plain(got)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key] == b[key], key
    assert [repr(j.healthy_iter_time) for j in want.jobs] == [
        repr(j.healthy_iter_time) for j in got.jobs
    ]


def test_build_campaign_other_seeds_and_sizes_match_the_reference():
    for preset, jobs, seed in (("mixed_fleet", 5, 3), ("failslow_storm", 3, 7)):
        want = ref_scenarios.build_campaign(preset, n_jobs=jobs, seed=seed)
        got = build_campaign(preset, n_jobs=jobs, seed=seed, device="cpu")
        assert _plain(want) == _plain(got)


def test_fault_model_draws_the_reference_stream():
    kw = dict(rate_per_hour=400.0, flap_prob=0.3, hang_prob=0.2)
    want = ref_scenarios.FaultModel(**kw).sample_schedule(
        np.random.default_rng(5), n_nodes=4, gpus_per_node=8, horizon_s=7200.0)
    got = FaultModel(**kw).sample_schedule(
        np.random.default_rng(5), n_nodes=4, gpus_per_node=8, horizon_s=7200.0)
    assert len(got) > 100
    assert _plain(want) == _plain(got)


def test_executor_fault_model_draws_the_reference_stream():
    ref = ref_scenarios.ExecutorFaultModel(0.3, 0.2, seed=4)
    port = ExecutorFaultModel(0.3, 0.2, seed=4)
    names = ["IGNORE", "ADJUST_MICROBATCH", "ADJUST_TOPOLOGY", "CKPT_AND_RESTART"]
    for i in range(200):
        name = names[i % len(names)]
        a = ref("j0", ref_events.Strategy[name], 1, float(i))
        b = port("j0", port_events.Strategy[name], 1, float(i))
        assert a == b, (i, name)
    assert ref.calls == port.calls == 150
    snap = port.snapshot()
    after = [port("j0", "S2P", 1, 0.0) for _ in range(20)]
    port.restore(snap)
    assert [port("j0", "S2P", 1, 0.0) for _ in range(20)] == after


# ------------------------------------------------- injector composition
def _state(n_nodes=2, gpn=4):
    return ClusterState(ClusterSpec(n_nodes=n_nodes, gpus_per_node=gpn))


def test_overlapping_gpu_injections_compose_and_relieve():
    inj = FailSlowInjector([
        Injection(0.0, 100.0, InjectionKind.GPU_SLOW, (1,), 0.5),
        Injection(50.0, 100.0, InjectionKind.GPU_SLOW, (1,), 0.5),
    ])
    st = _state()
    inj.apply(st, 25.0)
    assert st.devices[1].compute_speed == pytest.approx(0.5)
    inj.apply(st, 75.0)
    assert st.devices[1].compute_speed == pytest.approx(0.25)
    inj.apply(st, 125.0)
    assert st.devices[1].compute_speed == pytest.approx(0.5)
    inj.apply(st, 200.0)
    assert st.devices[1].compute_speed == pytest.approx(1.0)


def test_overlapping_link_and_nic_injections_compose():
    inj = FailSlowInjector([
        Injection(0.0, 100.0, InjectionKind.LINK_CONGESTION, (0, 5), 0.5),
        Injection(20.0, 100.0, InjectionKind.LINK_CONGESTION, (5, 0), 0.5),
        Injection(0.0, 100.0, InjectionKind.NIC_CONGESTION, (1,), 0.4),
        Injection(30.0, 100.0, InjectionKind.NIC_CONGESTION, (1,), 0.5),
    ])
    st = _state()
    inj.apply(st, 50.0)
    assert st.link_mult[(0, 5)] == pytest.approx(0.25)
    assert st.nic_mult[1] == pytest.approx(0.3)
    inj.apply(st, 110.0)
    assert st.link_mult[(0, 5)] == pytest.approx(0.5)
    assert st.nic_mult[1] == pytest.approx(0.5)
    inj.apply(st, 200.0)
    assert not st.link_mult and not st.nic_mult


def test_ramped_injection_builds_linearly_and_memoizes():
    inj = FailSlowInjector([
        Injection(0.0, 100.0, InjectionKind.GPU_SLOW, (2,), 0.4, ramp=50.0),
    ])
    st = _state()
    inj.apply(st, 25.0)
    assert st.devices[2].compute_speed == pytest.approx(0.8)
    inj.apply(st, 75.0)
    assert st.devices[2].compute_speed == pytest.approx(0.6)
    v = st.version
    inj.apply(st, 80.0)
    assert st.version == v
    inj.apply(st, 150.0)
    assert st.devices[2].compute_speed == pytest.approx(1.0)


# ------------------------------------------- node/NIC-scoped diagnoses
def _drive(plane, sims, mutate, n=140, when=60, seed=2):
    rng = np.random.default_rng(seed)
    wall = 0.0
    for t in range(n):
        if t == when:
            mutate()
        times = {
            job_id: sim.iteration_time() * float(rng.normal(1, 0.003))
            for job_id, sim in sims.items()
        }
        wall += max(times.values())
        plane.tick(times, wall)


def _cpu_plane():
    return ControlPlane(fleet_kwargs={"device": "cpu"})


def test_cpu_contention_dedupes_across_colocated_jobs_via_hosts():
    class CountingSim(TrainingSimulator):
        def __post_init__(self):
            super().__post_init__()
            self.profile_calls = 0

        def profile_groups(self):
            self.profile_calls += 1
            return super().profile_groups()

    def mk():
        return CountingSim(
            cluster=ClusterSpec(n_nodes=1, gpus_per_node=4),
            job=JobSpec(model=MODEL, tp=1, dp=4, pp=1, micro_batches=8),
            device="cpu",
        )

    sim_a, sim_b = mk(), mk()
    plane = _cpu_plane()
    plane.register_job("A", sim_a, hardware=[f"a{i}" for i in range(4)],
                       hosts=["h0"])
    plane.register_job("B", sim_b, hardware=[f"b{i}" for i in range(4)],
                       hosts=["h0"])

    def contend():
        for sim in (sim_a, sim_b):
            for d in range(4):
                sim.state.devices[d].host_speed = 0.5

    _drive(plane, {"A": sim_a, "B": sim_b}, contend)
    open_diags = [d for d in plane.diagnoses() if not d.resolved]
    assert sorted(d.job_id for d in open_diags) == ["A", "B"]
    for d in open_diags:
        assert d.event.root_cause is RootCause.CPU_CONTENTION
        assert d.event.components == ["node:0"]
        assert d.components_global == ("node:h0",)
    by_job = {d.job_id: d for d in open_diags}
    assert by_job["A"].deduped_from is None
    assert by_job["B"].deduped_from == "A"
    assert sim_a.profile_calls + sim_b.profile_calls == 1


def test_nic_congestion_pinpoints_nic_scoped_component():
    sim = TrainingSimulator(
        cluster=ClusterSpec(n_nodes=2, gpus_per_node=2),
        job=JobSpec(model=MODEL, tp=1, dp=4, pp=1, micro_batches=8),
        device="cpu",
    )
    plane = _cpu_plane()
    plane.register_job("A", sim, hardware=[f"g{i}" for i in range(4)],
                       hosts=["h0", "h1"])
    _drive(plane, {"A": sim}, lambda: sim.state.degrade_nic(0, 0.25))
    diags = [d for d in plane.diagnoses() if not d.resolved]
    assert diags
    d = diags[0]
    assert d.event.root_cause is RootCause.NETWORK_CONGESTION
    assert any(c.startswith("nic:") for c in d.event.components)
    assert any(c == "nic:h0" for c in d.components_global)


def test_adoption_rejected_when_components_measure_healthy():
    sim_a = TrainingSimulator(
        cluster=ClusterSpec(n_nodes=2, gpus_per_node=2),
        job=JobSpec(model=MODEL, tp=1, dp=4, pp=1, micro_batches=8),
        device="cpu",
    )
    sim_b = TrainingSimulator(
        cluster=ClusterSpec(n_nodes=1, gpus_per_node=4),
        job=JobSpec(model=MODEL, tp=1, dp=4, pp=1, micro_batches=8),
        device="cpu",
    )
    plane = _cpu_plane()
    plane.register_job("A", sim_a, hardware=[f"a{i}" for i in range(4)],
                       hosts=["h0", "h1"])
    plane.register_job("B", sim_b, hardware=[f"b{i}" for i in range(4)],
                       hosts=["h0"])

    def faults():
        sim_a.state.degrade_nic(0, 0.25)
        sim_b.state.devices[1].compute_speed = 0.5

    _drive(plane, {"A": sim_a, "B": sim_b}, faults)
    by_job = {}
    for d in plane.diagnoses():
        if not d.resolved:
            by_job.setdefault(d.job_id, d)
    assert by_job["A"].event.root_cause is RootCause.NETWORK_CONGESTION
    assert by_job["B"].event.root_cause is RootCause.GPU_DEGRADATION
    assert by_job["B"].deduped_from is None
    assert by_job["B"].event.components == ["gpu:1"]


# --------------------------------------------------- campaign runner
def _toy_preset(max_ticks=260):
    return ScenarioPreset(
        name="toy_2job",
        description="tier-1 smoke: two small jobs, one fault each",
        n_nodes=2, gpus_per_node=4, tick_seconds=5.0, max_ticks=max_ticks,
        default_jobs=2, join_spread_ticks=30,
        job_templates=(
            JobTemplate("yi-9b", tp=1, dp=2, pp=2, micro_batches=8),
        ),
        fixed_schedule=lambda n_nodes, gpn, dt: [
            Injection(100 * dt, 100 * dt, InjectionKind.GPU_SLOW, (1,), 0.5),
            Injection(120 * dt, 90 * dt, InjectionKind.GPU_SLOW, (5,), 0.6),
        ],
    )


def test_toy_campaign_smoke():
    spec, runs, report = run_and_score(_toy_preset(), n_jobs=2, seed=0,
                                       device="cpu")
    assert set(runs) == set(MODES)
    det = report["detection"]["overall"]
    assert det["precision"] == 1.0
    assert det["recall"] == 1.0
    assert det["latency_mean_s"] is not None
    assert report["mitigation"]["slowdown_mitigated_pct"] is not None
    joins = [m for m in report["membership"] if m["action"] == "join"]
    leaves = [m for m in report["membership"] if m["action"] == "leave"]
    assert len(joins) == 2 and len(leaves) == 2
    for row in report["jobs"]:
        assert all(row["finished"].values()), row
    assert json.dumps(report)


def test_toy_campaign_report_equals_the_reference():
    """A campaign no committed report covers (a custom preset, seed 3)
    scores the same through both packages."""
    from repro.cluster import injector as ref_inj

    ref_preset = ref_scenarios.ScenarioPreset(
        name="toy_2job", description="tier-1 smoke: two small jobs",
        n_nodes=2, gpus_per_node=4, tick_seconds=5.0, max_ticks=260,
        default_jobs=2, join_spread_ticks=30,
        job_templates=(ref_scenarios.JobTemplate(
            "yi-9b", tp=1, dp=2, pp=2, micro_batches=8),),
        fixed_schedule=lambda n_nodes, gpn, dt: [
            ref_inj.Injection(100 * dt, 100 * dt, ref_inj.InjectionKind.GPU_SLOW,
                              (1,), 0.5),
            ref_inj.Injection(120 * dt, 90 * dt, ref_inj.InjectionKind.GPU_SLOW,
                              (5,), 0.6),
        ],
    )
    _, _, want = ref_scenarios.run_and_score(ref_preset, n_jobs=2, seed=3)
    preset = dataclasses.replace(_toy_preset(), description=ref_preset.description)
    _, _, got = run_and_score(preset, n_jobs=2, seed=3, device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_campaign_determinism_byte_identical():
    preset = _toy_preset()
    blobs = []
    for _ in range(2):
        _, _, report = run_and_score(preset, n_jobs=2, seed=3, device="cpu")
        blobs.append(json.dumps(report, sort_keys=True))
    assert blobs[0] == blobs[1]


def test_campaign_seed_changes_schedule():
    spec0 = build_campaign("mixed_fleet", n_jobs=4, seed=0, device="cpu")
    spec1 = build_campaign("mixed_fleet", n_jobs=4, seed=1, device="cpu")
    assert spec0.schedule != spec1.schedule


def test_fault_model_statistics():
    fm = FaultModel(rate_per_hour=400.0, flap_prob=0.0)
    rng = np.random.default_rng(0)
    injs = fm.sample_schedule(rng, n_nodes=8, gpus_per_node=8,
                              horizon_s=3600.0)
    assert 300 < len(injs) < 500
    kinds = {k: sum(1 for i in injs if i.kind is k) for k in InjectionKind}
    hang_kinds = (InjectionKind.GPU_HANG, InjectionKind.COLLECTIVE_HANG)
    assert all(v > 0 for k, v in kinds.items() if k not in hang_kinds)
    assert all(kinds[k] == 0 for k in hang_kinds)
    durs = np.array([i.duration for i in injs])
    assert durs.min() >= 10.0 and durs.max() <= 40_000.0
    assert np.median(durs) < 3600.0
    sevs = np.array([i.severity for i in injs])
    assert 0.08 <= sevs.min() and sevs.max() <= 0.92
    ramps = [i for i in injs if i.ramp > 0]
    assert ramps and all(
        i.kind in (InjectionKind.LINK_CONGESTION, InjectionKind.NIC_CONGESTION)
        for i in ramps
    )


def test_campaign_translates_global_faults_to_affected_jobs_only():
    spec = build_campaign(_toy_preset(), n_jobs=2, seed=0, device="cpu")
    by_job = {p.job_id: p for p in spec.jobs}
    assert [li.target for li in by_job["j0"].local_schedule] == [(1,)]
    assert [li.target for li in by_job["j1"].local_schedule] == [(1,)]
    assert all(i > 0 for p in spec.jobs for i in p.impacts)


def test_mixed_fleet_acceptance_campaign():
    spec, runs, report = run_and_score("mixed_fleet", n_jobs=8, seed=0,
                                       device="cpu")
    det = report["detection"]["overall"]
    assert det["precision"] == 1.0
    assert det["recall"] == 1.0
    assert report["mitigation"]["slowdown_mitigated_pct"] >= 45.0
    falcon = runs["falcon"]
    joins = sorted(o.join_time for o in falcon.outcomes.values())
    ends = sorted(o.end_time for o in falcon.outcomes.values()
                  if o.end_time is not None)
    assert joins[-1] > 0.0
    assert ends and ends[0] < falcon.horizon_s
    assert "per_cause" in report["detection"]
    assert report["mitigation"]["slowdown_mitigated_ckpt_pct"] is not None
    assert report["mitigation"]["avg_jct_delay_pct"] is not None


def test_scoring_counts_unmatched_diagnosis_as_false_positive():
    spec = build_campaign(_toy_preset(max_ticks=220), n_jobs=2, seed=0,
                          device="cpu")
    runs = {mode: run_campaign(spec, mode, device="cpu") for mode in MODES}
    fake = Diagnosis(
        job_id="j0", time=40.0,
        event=FailSlowEvent(start_time=40.0,
                            root_cause=RootCause.GPU_DEGRADATION),
    )
    runs["falcon"].events.append(fake)
    report = score_campaign(spec, runs)
    assert report["detection"]["overall"]["false_positives"] >= 1
    assert report["detection"]["overall"]["precision"] < 1.0


def test_list_presets_cli(capsys):
    campaign_cli.main(["--list-presets"])
    out = capsys.readouterr().out
    assert {ln.split()[0] for ln in out.splitlines()} == set(PRESETS)
