"""The port's observability layer (``repro_torch.obs``) held against the
JAX package's: tracer and metrics unit twins, the committed sidecars of
``collective_hang-j2-s0`` and ``mixed_fleet-j8-s0`` regenerated byte for
byte, tracing that never changes a run, and dashboards whose HTML equals
the reference's for the same report.
"""
import json
import math
import os

import pytest

from repro.obs import recorder as ref_recorder
from repro.obs.dashboard import render_dashboard as ref_render
from repro_torch.cluster.simulator import JobSpec, ModelSpec, TrainingSimulator
from repro_torch.cluster.spec import ClusterSpec, ClusterState
from repro_torch.controlplane.events import (
    Diagnosis,
    Observation,
    event_log_records,
    event_record,
)
from repro_torch.launch import obs as obs_cli
from repro_torch.obs import (
    COMPONENTS,
    MetricsRegistry,
    SpanTracer,
    TraceError,
    decompose,
)
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs.dashboard import render_dashboard
from repro_torch.scenarios.campaign import build_campaign, run_campaign
from repro_torch.scenarios.scoring import run_and_score, write_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGNS = os.path.join(REPO, "results", "campaigns")
CPU = "cpu"


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def hang_campaign():
    spec = build_campaign("collective_hang", n_jobs=2, seed=0, device=CPU)
    tracer = SpanTracer()
    run = run_campaign(spec, "falcon", tracer=tracer, device=CPU)
    return spec, run


@pytest.fixture(scope="module")
def scored_obs():
    return run_and_score("single_gpu_throttle", n_jobs=1, seed=0, obs=True,
                         device=CPU)


def _sim(tp=2, dp=2, pp=2, nodes=2, gpn=4):
    return TrainingSimulator(
        cluster=ClusterSpec(n_nodes=nodes, gpus_per_node=gpn),
        job=JobSpec(
            model=ModelSpec(layers=8, hidden=1024, seq_len=512, vocab=32000),
            tp=tp, dp=dp, pp=pp, micro_batches=8,
        ),
        reduction="vectorized",
    )


# ------------------------------------------------------------ SpanTracer
def test_tracer_nesting_and_chrome_export():
    tr = SpanTracer()
    tr.begin(("j0", "t"), "outer", 0.0)
    tr.begin(("j0", "t"), "inner", 1.0)
    tr.end(("j0", "t"), 2.0)
    tr.end(("j0", "t"), 3.0, args={"k": 1})
    tr.instant(("j0", "t"), "mark", 1.5)
    doc = tr.to_chrome()
    by_name = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert by_name["inner"]["ts"] == 1_000_000
    assert by_name["inner"]["dur"] == 1_000_000
    assert by_name["outer"]["ts"] == 0
    assert by_name["outer"]["dur"] == 3_000_000


def test_tracer_end_without_begin_raises():
    with pytest.raises(TraceError):
        SpanTracer().end(("j0", "t"), 1.0)


def test_tracer_name_mismatch_raises():
    tr = SpanTracer()
    tr.begin(("j0", "t"), "a", 0.0)
    with pytest.raises(TraceError):
        tr.end(("j0", "t"), 1.0, name="b")


def test_tracer_export_with_open_span_raises_until_closed():
    tr = SpanTracer()
    tr.begin(("j0", "t"), "open", 0.0)
    with pytest.raises(TraceError):
        tr.to_chrome()
    tr.close_all(5.0)
    spans = [e for e in tr.to_chrome()["traceEvents"] if e["ph"] == "X"]
    assert spans[0]["dur"] == 5_000_000


def test_tracer_json_equals_the_reference_tracer():
    from repro.obs import SpanTracer as RefTracer

    def build(cls):
        tr = cls()
        tr.span(("b", "y"), "s2", 1.0, 2.0, args={"x": [1, 2]})
        tr.span(("a", "x"), "s1", 0.0, 1.0)
        tr.begin(("a", "x"), "open", 1.5)
        tr.counter(("a", "c"), "v", 0.5, 3.14159265)
        tr.instant(("b", "y"), "mark", 1.25, args={"why": "test"})
        tr.close_all(4.0)
        return tr

    assert build(SpanTracer).to_json() == build(SpanTracer).to_json()
    assert build(SpanTracer).to_json() == build(RefTracer).to_json()
    evs = build(SpanTracer).to_chrome()["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert evs[: len(meta)] == meta
    pids = {e["args"]["name"]: e["pid"] for e in meta
            if e["name"] == "process_name"}
    assert len(set(pids.values())) == len(pids)


# ------------------------------------------------- collective breakdown
def test_decompose_parts_sum_to_iteration_time():
    sim = _sim()
    bd = decompose(sim)
    assert math.isclose(sum(bd.parts().values()), sim.iteration_time(),
                        rel_tol=1e-9)
    assert bd.bottleneck in COMPONENTS
    assert 0.0 < bd.share <= 1.0


@pytest.mark.parametrize(
    "edge,collective",
    [((0, 2), "dp_allreduce"), ((0, 1), "tp_allreduce"), ((0, 4), "pp_p2p")],
)
def test_decompose_degraded_link_shifts_bottleneck_and_names_edge(edge, collective):
    sim = _sim()
    healthy = decompose(sim)
    assert healthy.bottleneck == "compute"
    state = ClusterState(sim.cluster)
    state.degrade_link(*edge, 0.01)
    sim.state = state
    degraded = sim.collective_breakdown()
    assert degraded.bottleneck == collective
    assert degraded.edge == f"link:{edge[0]}-{edge[1]}"
    assert degraded.parts()[collective] > healthy.parts()[collective] * 10


# --------------------------------------------------- metrics registry
def test_metrics_counter_gauge_histogram_snapshot():
    reg = MetricsRegistry()
    reg.counter("hits", job="j0").inc()
    reg.counter("hits", job="j0").inc(2.0)
    reg.gauge("level").set(0.25)
    h = reg.histogram("lat_s", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 100.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["counters"] == [
        {"name": "hits", "labels": {"job": "j0"}, "value": 3.0}
    ]
    assert snap["gauges"][0]["value"] == 0.25
    hist = snap["histograms"][0]
    assert hist["count"] == 3
    assert hist["buckets"] == {"1": 1, "10": 2, "+Inf": 3}
    assert hist["sum"] == 105.5


def test_metrics_kind_collision_and_negative_inc_raise():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.counter("y").inc(-1.0)


def test_metrics_json_equals_the_reference_registry():
    from repro.obs import MetricsRegistry as RefRegistry

    def build(cls):
        reg = cls()
        reg.counter("events_total", kind="Flag").inc(3)
        reg.gauge("level", job="j1").set(1.0 / 3.0)
        h = reg.histogram("lat_s", buckets=(0.5, 5.0, 50.0))
        for v in (0.1, 0.7, 7.0, 70.0, 2.0 / 3.0):
            h.observe(v)
        return reg

    assert build(MetricsRegistry).to_json() == build(RefRegistry).to_json()


# ------------------------------------------- control-plane integration
def test_hang_diagnosis_breakdown_names_injected_ring_edge(hang_campaign):
    spec, run = hang_campaign
    hang_inj = next(
        inj for inj in spec.schedule if inj.kind.value == "collective_hang"
    )
    a, b = hang_inj.target
    placed = next(p for p in spec.jobs if a in p.devices and b in p.devices)
    devs = list(placed.devices)
    la, lb = sorted((devs.index(a), devs.index(b)))
    onsets = [
        e for e in run.events
        if isinstance(e, Diagnosis) and not e.resolved
        and e.job_id == placed.job_id
    ]
    diag = next(e for e in onsets if getattr(e.event, "hang", False))
    assert diag.breakdown.bottleneck == "dp_allreduce"
    assert diag.breakdown.edge == f"link:{la}-{lb}"
    assert "breakdown" not in event_record(diag)


def test_tracing_does_not_change_behavior(hang_campaign):
    spec, traced = hang_campaign
    plain = run_campaign(spec, "falcon", device=CPU)
    assert event_log_records(traced.events) == event_log_records(plain.events)
    assert {
        j: (o.iters_done, o.end_time) for j, o in traced.outcomes.items()
    } == {j: (o.iters_done, o.end_time) for j, o in plain.outcomes.items()}


def test_trace_covers_pipeline_and_is_deterministic(hang_campaign):
    spec, run = hang_campaign
    names = {
        e["name"] for e in run.tracer.to_chrome()["traceEvents"]
        if e["ph"] == "X"
    }
    for expected in ("tick", "job", "silence", "deadline"):
        assert expected in names, f"missing {expected} spans"
    assert any(n.startswith("fault:") for n in names)
    assert any(n.startswith("inject:") for n in names)
    assert any(n.startswith("dispatch:") for n in names)
    tr2 = SpanTracer()
    run_campaign(spec, "falcon", tracer=tr2, device=CPU)
    assert run.tracer.to_json() == tr2.to_json()


def test_event_log_records_observation_stride():
    events = [
        Observation(job_id="j0", time=float(i), iter_time=1.0, step=i)
        for i in range(10)
    ]
    assert event_log_records(events) == []
    kept = event_log_records(events, observation_stride=3)
    assert [r["step"] for r in kept] == [0, 3, 6, 9]


# ------------------------------------------------- recorder + dashboard
@pytest.mark.parametrize("preset,jobs", [("collective_hang", 2),
                                         ("mixed_fleet", 8)])
def test_committed_sidecars_regenerate_byte_identical(preset, jobs, tmp_path):
    spec, runs, report = run_and_score(preset, n_jobs=jobs, seed=0, obs=True,
                                       device=CPU)
    write_report(report, str(tmp_path))
    paths = obs_recorder.write_sidecars(spec, runs, report, out_dir=str(tmp_path))
    assert sorted(paths) == ["metrics", "trace"]
    base = f"{preset}-j{jobs}-s0"
    for suffix in (".json", ".trace.json", ".metrics.json"):
        got = (tmp_path / (base + suffix)).read_bytes()
        with open(os.path.join(CAMPAIGNS, base + suffix), "rb") as f:
            assert got == f.read(), suffix


def test_sidecars_byte_deterministic_and_report_unchanged(scored_obs, tmp_path):
    spec, runs, report = scored_obs
    paths_a = obs_recorder.write_sidecars(spec, runs, report,
                                          out_dir=str(tmp_path / "a"))
    spec2, runs2, report2 = run_and_score(
        "single_gpu_throttle", n_jobs=1, seed=0, obs=True, device=CPU
    )
    paths_b = obs_recorder.write_sidecars(spec2, runs2, report2,
                                          out_dir=str(tmp_path / "b"))
    assert report == report2
    for kind in ("trace", "metrics"):
        with open(paths_a[kind]) as fa, open(paths_b[kind]) as fb:
            assert fa.read() == fb.read(), kind
    _, _, plain = run_and_score("single_gpu_throttle", n_jobs=1, seed=0,
                                device=CPU)
    assert report == plain


def test_recorder_metric_catalog(scored_obs):
    spec, runs, report = scored_obs
    snap = obs_recorder.record_campaign(spec, runs, report).snapshot()
    counters = {c["name"] for c in snap["counters"]}
    gauges = {g["name"] for g in snap["gauges"]}
    hists = {h["name"] for h in snap["histograms"]}
    assert {"events_total", "diagnoses_total"} <= counters
    assert {"wasted_gpu_seconds", "slowdown_mitigated_pct"} <= gauges
    assert {"detection_latency_s", "fault_duration_s"} <= hists


def test_recorder_equals_the_reference_recorder(scored_obs):
    from repro.scenarios import run_and_score as ref_run_and_score

    spec, runs, report = scored_obs
    rspec, rruns, rreport = ref_run_and_score(
        "single_gpu_throttle", n_jobs=1, seed=0, obs=True
    )
    assert report == rreport
    assert (obs_recorder.record_campaign(spec, runs, report).to_json()
            == ref_recorder.record_campaign(rspec, rruns, rreport).to_json())
    assert runs["falcon"].tracer.to_json() == rruns["falcon"].tracer.to_json()


def test_dashboard_renders_deterministically(scored_obs):
    _, _, report = scored_obs
    html = render_dashboard(report)
    assert html == render_dashboard(report)
    assert html.count("<svg") == 3
    for jid in (r["job_id"] for r in report["jobs"]):
        assert jid in html


@pytest.mark.parametrize("base", ["mixed_fleet-j8-s0", "collective_hang-j2-s0",
                                  "failslow_storm-j6-s0"])
def test_dashboard_html_equals_the_reference(base):
    with open(os.path.join(CAMPAIGNS, base + ".json")) as f:
        report = json.load(f)
    metrics = None
    path = os.path.join(CAMPAIGNS, base + ".metrics.json")
    if os.path.exists(path):
        with open(path) as f:
            metrics = json.load(f)
    assert render_dashboard(report, metrics) == ref_render(report, metrics)
    assert render_dashboard(report) == ref_render(report)


def test_dashboard_cli_writes_beside_a_copied_report(tmp_path, monkeypatch, capsys):
    base = "collective_hang-j2-s0"
    for suffix in (".json", ".metrics.json"):
        with open(os.path.join(CAMPAIGNS, base + suffix), "rb") as f:
            (tmp_path / (base + suffix)).write_bytes(f.read())
    report_path = tmp_path / (base + ".json")
    monkeypatch.setattr("sys.argv", ["obs", "--report", str(report_path)])
    obs_cli.main()
    out = tmp_path / (base + ".html")
    assert f"dashboard: {out}" in capsys.readouterr().out
    with open(report_path) as f:
        report = json.load(f)
    with open(tmp_path / (base + ".metrics.json")) as f:
        metrics = json.load(f)
    assert out.read_text() == ref_render(report, metrics)
