"""The port's seed-sweep CLI (``repro_torch.launch.sweep``) held against
the committed tables: the three ``results/sweeps/*-seeds*.json`` tables and
the two gate baselines regenerate byte for byte through ``--device cpu``
into a temp dir; the gate arithmetic, the gate's exit codes and the spawn
pool are the twins of ``tests/test_ci_gate.py``'s.
"""
import json
import os

import pytest
import torch

from repro.launch import sweep as ref_sweep
from repro_torch.launch import sweep as sweep_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEPS = os.path.join(REPO, "results", "sweeps")
BASELINE = os.path.join(SWEEPS, "single_gpu_throttle-j1.baseline.json")
HANG_BASELINE = os.path.join(SWEEPS, "collective_hang-j2.baseline.json")

#: committed tables: (preset, jobs, seeds, whether a gate baseline exists)
TABLES = [
    ("single_gpu_throttle", 1, 3, True),
    ("collective_hang", 2, 3, True),
    ("mixed_fleet", 8, 5, False),
]


def _committed(name: str) -> bytes:
    with open(os.path.join(SWEEPS, name), "rb") as f:
        return f.read()


def load_baseline(path=BASELINE) -> dict:
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("preset,jobs,seeds,has_baseline", TABLES,
                         ids=[t[0] for t in TABLES])
def test_committed_sweep_and_baseline_regenerate(preset, jobs, seeds,
                                                 has_baseline, tmp_path, capsys):
    """One CLI run writes the table and, where one is committed, the gate
    baseline; both equal the committed files byte for byte, and gating the
    run against the committed baseline passes."""
    argv = ["--preset", preset, "--jobs", str(jobs), "--seeds", str(seeds),
            "--device", "cpu", "--out", str(tmp_path), "--quiet"]
    baseline = tmp_path / f"{preset}-j{jobs}.baseline.json"
    if has_baseline:
        argv += ["--write-baseline", str(baseline),
                 "--gate", os.path.join(SWEEPS, baseline.name)]
    assert sweep_mod.main(argv) == 0
    out = capsys.readouterr().out
    table = f"{preset}-j{jobs}-seeds{seeds}.json"
    assert (tmp_path / table).read_bytes() == _committed(table)
    if has_baseline:
        assert "GATE PASS" in out
        assert baseline.read_bytes() == _committed(baseline.name)


def test_committed_tables_are_all_covered():
    names = sorted(os.listdir(SWEEPS))
    want = sorted(
        [f"{p}-j{j}-seeds{s}.json" for p, j, s, _ in TABLES]
        + [f"{p}-j{j}.baseline.json" for p, j, _, b in TABLES if b]
    )
    assert names == want


def test_aggregate_and_table_equal_the_reference():
    with open(os.path.join(SWEEPS, "mixed_fleet-j8-seeds5.json")) as f:
        sweep = json.load(f)
    assert sweep_mod.sweep_table(sweep) == ref_sweep.sweep_table(sweep)
    vals = [1.0, 2.5, 7.25]
    assert sweep_mod._stats(vals) == ref_sweep._stats(vals)
    assert sweep_mod.METRICS == ref_sweep.METRICS
    assert sweep_mod.GATE_SCHEMA_KEYS == ref_sweep.GATE_SCHEMA_KEYS


# ------------------------------------------------------------- the gate
def test_committed_baseline_parses_and_matches_gate_schema():
    baseline = load_baseline()
    for key in sweep_mod.GATE_SCHEMA_KEYS:
        assert key in baseline, f"baseline missing {key!r}"
    gate = baseline["gate"]
    assert gate["metric"] in dict(sweep_mod.METRICS)
    assert float(gate["max_drop_pct_points"]) > 0
    m = baseline["metrics"][gate["metric"]]
    assert m["mean"] is not None
    assert m["n"] == baseline["seeds"] > 1


def test_gate_arithmetic_passes_identity_and_fails_regression():
    baseline = load_baseline()
    passed, _ = sweep_mod.check_gate({"metrics": baseline["metrics"]}, baseline)
    assert passed
    metric = baseline["gate"]["metric"]
    allowed = baseline["gate"]["max_drop_pct_points"]
    for drop, want in ((allowed - 0.01, True), (allowed + 0.01, False)):
        cur = {"metrics": {metric: {
            "mean": baseline["metrics"][metric]["mean"] - drop}}}
        passed, verdict = sweep_mod.check_gate(cur, baseline)
        assert passed is want
        assert metric in verdict
        assert ref_sweep.check_gate(cur, baseline) == (passed, verdict)


def test_gate_fails_on_missing_metric():
    baseline = load_baseline()
    metric = baseline["gate"]["metric"]
    passed, verdict = sweep_mod.check_gate(
        {"metrics": {metric: {"mean": None}}}, baseline
    )
    assert not passed and "missing" in verdict


def test_committed_hang_baseline_parses_and_matches_gate_schema():
    baseline = load_baseline(HANG_BASELINE)
    for key in sweep_mod.GATE_SCHEMA_KEYS:
        assert key in baseline
    assert baseline["metrics"]["hang_detection_rate"]["mean"] == 1.0


def test_gate_cli_exit_codes(tmp_path, capsys):
    """A regressed baseline fails the gate (exit 2); a baseline without the
    gate schema is an error (exit 2)."""
    baseline = load_baseline()
    metric = baseline["gate"]["metric"]
    baseline["metrics"][metric]["mean"] += 50.0
    high = tmp_path / "high.json"
    high.write_text(json.dumps(baseline))
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps({"preset": "single_gpu_throttle"}))
    common = ["--preset", "single_gpu_throttle", "--jobs", "1", "--seeds", "2",
              "--ticks", "160", "--device", "cpu", "--out", str(tmp_path),
              "--quiet"]
    assert sweep_mod.main(common + ["--gate", str(high)]) == 2
    assert "GATE FAIL" in capsys.readouterr().out
    assert sweep_mod.main(common + ["--gate", str(broken)]) == 2
    assert "GATE ERROR" in capsys.readouterr().out


def test_parallel_sweep_is_byte_identical_to_serial(tmp_path):
    """--workers fans seeds out over a spawn pool; the table equals the
    serial run byte for byte."""
    serial = sweep_mod.run_sweep(
        "single_gpu_throttle", seeds=2, max_ticks=160, workers=1, device="cpu"
    )
    fanned = sweep_mod.run_sweep(
        "single_gpu_throttle", seeds=2, max_ticks=160, workers=2, device="cpu"
    )
    assert serial == fanned
    p1 = sweep_mod.write_sweep(serial, str(tmp_path / "serial"))
    p2 = sweep_mod.write_sweep(fanned, str(tmp_path / "fanned"))
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()


def test_sweep_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_mod.run_sweep("single_gpu_throttle", seeds=2, workers=2)
