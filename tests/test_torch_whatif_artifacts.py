"""The committed what-if artifacts regenerate byte for byte through the
port's CLI (``python -m repro_torch.launch.whatif --device cpu``), run from
the repository's root with the paths the reference's CLI was given, so the
explain artifact embeds the same baseline path:

* ``results/campaigns/{single_gpu_throttle-j1-s0,mixed_fleet-j8-s0}
  .attribution.json`` (``--report ... --leave-one-out``);
* ``results/whatif/explain-single_gpu_throttle-j1-s0.json``
  (``--explain``, which reads the committed sidecar beside the baseline);
* ``results/whatif/*-s3seeds-tuning.json`` (``--tune`` over three seeds).

Each goes to ``--out`` in a temp dir; without ``--out`` the CLI writes
under ``build/repro_torch_results``, never into ``results/``.
"""
import os
import shutil

import pytest

from repro_torch.launch import whatif as whatif_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SGT = "results/campaigns/single_gpu_throttle-j1-s0.json"


def _committed(rel: str) -> bytes:
    with open(os.path.join(REPO, rel), "rb") as f:
        return f.read()


def _run(argv, out, monkeypatch):
    monkeypatch.chdir(REPO)
    assert whatif_cli.main([*argv, "--device", "cpu", "--quiet", "--out", str(out)]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("name", ["single_gpu_throttle-j1-s0", "mixed_fleet-j8-s0"])
def test_attribution_sidecar_byte_identical(name, tmp_path, monkeypatch):
    report = f"results/campaigns/{name}.json"
    got = _run(["--report", report, "--leave-one-out"], tmp_path / "att.json", monkeypatch)
    assert got == _committed(f"results/campaigns/{name}.attribution.json")


def test_explain_artifact_byte_identical(tmp_path, monkeypatch):
    got = _run(["--preset", "single_gpu_throttle", "--jobs", "1", "--seed", "0",
                "--explain", SGT], tmp_path / "explain.json", monkeypatch)
    assert got == _committed("results/whatif/explain-single_gpu_throttle-j1-s0.json")


@pytest.mark.parametrize("preset,jobs", [("single_gpu_throttle", 1), ("collective_hang", 2),
                                         ("mixed_fleet", 8)])
def test_tuning_artifact_byte_identical(preset, jobs, tmp_path, monkeypatch):
    got = _run(["--preset", preset, "--jobs", str(jobs), "--seed", "0",
                "--tune", "breakeven_scale", "prediction_margin", "--tune-seeds", "3"],
               tmp_path / "tuning.json", monkeypatch)
    assert got == _committed(f"results/whatif/{preset}-j{jobs}-s3seeds-tuning.json")


def test_default_sidecar_goes_to_build_not_results(tmp_path, monkeypatch, capsys):
    """``--report R --leave-one-out`` without ``--out``: the sidecar lands
    in ``build/repro_torch_results/campaigns``; the report's directory is
    left as it was."""
    reports = tmp_path / "results" / "campaigns"
    reports.mkdir(parents=True)
    shutil.copy(os.path.join(REPO, SGT), reports)
    monkeypatch.chdir(tmp_path)
    assert whatif_cli.main(["--report", SGT, "--leave-one-out", "--device", "cpu",
                            "--quiet"]) == 0
    want = os.path.join("build", "repro_torch_results", "campaigns",
                        "single_gpu_throttle-j1-s0.attribution.json")
    assert f"attribution: {want}" in capsys.readouterr().out
    assert (tmp_path / want).read_bytes() == \
        _committed("results/campaigns/single_gpu_throttle-j1-s0.attribution.json")
    assert sorted(p.name for p in reports.iterdir()) == ["single_gpu_throttle-j1-s0.json"]
