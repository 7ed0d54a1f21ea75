"""The benchmark's files: every cell resolves, a cell made only of added
files loads, the yardstick's counts equal worked values, and no module the
runs import is JAX's or the JAX package's."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench, yardstick
from portbench.reference import weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def test_every_cell_resolves_to_its_files():
    b = bench.benchmark()
    for w in b["workloads"]:
        c = bench.cell(w["name"], b)
        assert bench.driver(c).run
        assert set(c.limits) and all(v >= 0 for v in c.limits.values())
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer
        for m in c.per_layer:
            assert callable(bench.reader(m["name"]))
            assert m["moves"] in {e["name"] for e in c.end_to_end}
        weights.sizes(c.config)
        assert c.traffic.get("host_threads", 1) in range(1, 65)
    for conf in b["configs"]:
        assert (ROOT / conf["file"]).is_file()


def test_a_cell_of_added_files_loads(tmp_path):
    b = bench.benchmark()
    for sub in ("configs", "traffic", "cells"):
        shutil.copytree(HERE / sub, tmp_path / "portbench" / sub)
    conf = json.loads((HERE / "configs" / "granite-3-8b.json").read_text())
    conf["num_hidden_layers"] = 8
    (tmp_path / "portbench" / "configs" / "granite-3-8b-pp5.json").write_text(json.dumps(conf))
    traffic = json.loads((HERE / "traffic" / "train-4k.json").read_text())
    traffic["slots"] = 4
    (tmp_path / "portbench" / "traffic" / "train-4k-4slots.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "cells" / "granite-3-8b-pp5.train-4k-4slots.json").write_text(
        json.dumps({"limits": {"loss_gap": 1e-3}}))
    b["configs"].append({"name": "granite-3-8b-pp5", "source": "x", "reduced": [], "why": "x",
                         "file": "portbench/configs/granite-3-8b-pp5.json"})
    b["workloads"].append({"name": "granite-3-8b-pp5.train-4k-4slots", "config": "granite-3-8b-pp5",
                           "traffic": "train-4k-4slots", "chips": 1, "why": "x"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "granite-3-8b.train-4k" in m["workloads"]:
            m["workloads"].append("granite-3-8b-pp5.train-4k-4slots")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = bench.cell("granite-3-8b-pp5.train-4k-4slots", root=tmp_path)
    assert weights.sizes(c.config)["layers"] == 8 and c.traffic["slots"] == 4
    assert c.limits == {"loss_gap": 1e-3}
    assert {m["name"] for m in c.per_layer} >= {"mfu.train", "idle_pct.train"}


def test_train_flops_equal_worked_values():
    # granite-3-8b stage: 10 layers of q, o (4096^2), k, v (4096 x 1024) and
    # three 4096 x 12800 MLP matrices, and a 4096 x 49155 head; 2 x 4096
    # tokens; causal attention 2 * S^2 * 32 * 128 a layer, times 3.
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 12800
    dense = 6 * (10 * layer + 4096 * 49155) * 8192
    attn = 3 * 2 * 10 * 2 * 4096**2 * 32 * 128
    g = weights.sizes(json.loads((HERE / "configs" / "granite-3-8b.json").read_text()))
    assert yardstick.train_step_flops(g, 4096, 2) == pytest.approx(dense + attn, rel=1e-12)
    assert yardstick.train_step_flops(g, 4096, 2) == pytest.approx(1.1607e14, rel=1e-4)
    # mamba2-2.7b: 64 layers of z, x, out (2560 x 5120), B/C (2560 x 256) and
    # dt (2560 x 80), a 2560 x 50280 head; 2 x 2048 tokens; the SSD's
    # 80 heads x 8 chunks of 256 x (2*32896*128 + 2*32896*64 + 4*256*128*64), times 3.
    layer = 3 * 2560 * 5120 + 2560 * 256 + 2560 * 80
    dense = 6 * (64 * layer + 2560 * 50280) * 4096
    ssd = 3 * 2 * 64 * 80 * 8 * (2 * 32896 * 128 + 2 * 32896 * 64 + 4 * 256 * 128 * 64)
    m = weights.sizes(json.loads((HERE / "configs" / "mamba2-2.7b.json").read_text()))
    assert yardstick.train_step_flops(m, 2048, 2) == pytest.approx(dense + ssd, rel=1e-12)
    assert yardstick.train_step_flops(m, 2048, 2) == pytest.approx(7.1530e13, rel=1e-4)


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(bench.FORBIDDEN), (path, tops & set(bench.FORBIDDEN))
    for path in (HERE / "reference").rglob("*.py"):
        mods = _imports(path)
        assert "repro_torch" not in {m.split(".")[0] for m in mods}, path
        assert all(m.startswith("portbench.reference") for m in mods if m.startswith("portbench")), path


def test_run_without_a_card_exits_without_a_result(tmp_path):
    """Without a CUDA card (this host), and in a copy that holds only
    BENCHMARK.json and the benchmark's folder, a run prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: a run would measure")
    name = bench.benchmark()["workloads"][0]["name"]
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for root in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                            "2147483700", "--seconds", "1", "--trace", "0"],
                           cwd=root, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == "", (p.returncode, p.stdout, p.stderr)


def test_expected_events_follow_the_trace():
    """FALCON's answer to the first episode, worked out from the trace:
    GPU 5 of a (tp 1, dp 16, pp 4) job is in data-parallel group 5."""
    from portbench.reference import events

    tr = json.loads((HERE / "traffic" / "train-4k.json").read_text())
    job = json.loads((HERE / "configs" / "granite-3-8b.json").read_text())["deployment"]["watched_job"]
    exp = events.expected(tr, job)
    assert exp["components"] == ["gpu:5"] and exp["cause"] == "gpu_degradation"
    assert (exp["onset"], exp["until"], exp["slow_group"]) == (6, 131, 5)
    diag = {"type": "Diagnosis", "time": 9.0, "cause": "gpu_degradation", "components": ["gpu:5"]}
    s1 = {"type": "MitigationResult", "time": 9.0, "strategy": "IGNORE", "applied": True,
          "status": "ok", "kind": "mitigate", "allocation": None}
    s2 = dict(s1, time=15.0, strategy="ADJUST_MICROBATCH", allocation=[5, 5] + [4] * 13 + [2])
    assert events.mismatches([diag, s1], 10.0, 1.0, exp) == []
    assert len(events.mismatches([diag, s1], 30.0, 1.0, exp)) == 1     # no S2 by 22
    assert len(events.mismatches([diag, s1, s2], 30.0, 1.0, exp)) == 1  # group 15 the fewest
    s2["allocation"] = [5, 5, 4, 4, 4, 2] + [4] * 10
    assert events.mismatches([diag, s1, s2], 30.0, 1.0, exp) == []
    assert len(events.mismatches([s1, s2], 30.0, 1.0, exp)) == 1        # no diagnosis
