"""The port stands alone: importing ``repro_torch``, running a control
plane tick, serving one smoke-size prefill + decode step, taking one
smoke-size training step, scoring one campaign and writing its
observability sidecars, and replaying one what-if variant load neither jax
nor the JAX package (checked in a fresh interpreter), and the default entry
points want the card."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

_PROGRAM = textwrap.dedent("""
    import sys
    import numpy as np
    from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
    from repro_torch.cluster.spec import ClusterSpec, ModelSpec
    from repro_torch.controlplane import ControlPlane
    from repro_torch.convert import fleet_snapshot_from_reference  # noqa: F401

    sim = TrainingSimulator(
        cluster=ClusterSpec(n_nodes=1),
        job=JobSpec(model=ModelSpec(layers=8, hidden=1024, seq_len=1024,
                                    vocab=32000),
                    tp=2, dp=2, pp=2, micro_batches=8),
        reduction="torch", device="cpu",
    )
    plane = ControlPlane(screening_backend="torch", fleet_kwargs={"device": "cpu"})
    plane.register_job("job", sim)
    for tick in range(12):
        plane.tick({"job": sim.iteration_time()}, 5.0 * (tick + 1))

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as model_lib

    cfg = get_config("granite-3-8b").smoke()
    params = model_lib.init_params(cfg, 0, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    res = serve(cfg, params, prompt, gen=1, use_kernel=True, device="cpu")
    assert res.tokens.shape == (2, 1), res.tokens.shape

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import train_simulator
    from repro_torch.train.trainer import FalconTrainer

    cfg = get_config("mamba2-2.7b").smoke()
    data = DataConfig(seq_len=16, global_batch=4, slots=2, dp_groups=2)
    trainer = FalconTrainer(cfg=cfg, data=data, device="cpu",
                            perf_model=train_simulator(cfg, data, device="cpu"))
    hist = trainer.run(1)
    assert np.isfinite(hist[0].loss), hist

    import tempfile
    from repro_torch.launch import campaign, obs, sweep  # noqa: F401
    from repro_torch.obs.dashboard import render_dashboard
    from repro_torch.obs.recorder import write_sidecars
    from repro_torch.scenarios import run_and_score

    spec, runs, report = run_and_score("single_gpu_throttle", device="cpu",
                                       obs=True)
    with tempfile.TemporaryDirectory() as out:
        paths = write_sidecars(spec, runs, report, out_dir=out)
        assert sorted(paths) == ["metrics", "trace"], paths
    assert render_dashboard(report).count("<svg") == 3

    from repro_torch.launch import whatif  # noqa: F401
    from repro_torch.whatif import Variant, WhatIfEngine

    engine = WhatIfEngine.from_report(report, device="cpu")
    gids = engine.episodes_by_cause()["gpu_degradation"]
    run = engine.run_variant("falcon", Variant(drop_episodes=frozenset(gids)))
    assert engine.stats["variants"] == 1 and run.outcomes, engine.stats
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "repro" or m.startswith("repro."))
    print("LOADED:" + ",".join(bad))
""")


def test_port_loads_neither_jax_nor_reference_package():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", _PROGRAM], capture_output=True, text=True,
        env=env, timeout=300, check=True,
    ).stdout
    line = [ln for ln in out.splitlines() if ln.startswith("LOADED:")]
    assert line == ["LOADED:"], out


def test_auto_backends_raise_without_a_card():
    from repro_torch.core import bocd
    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present: auto resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bocd.select_backend("auto")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_model_entry_points_raise_without_a_card():
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    cfg = get_config("granite-3-8b").smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_lib.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_caches(cfg, 1, 4)
    params = model_lib.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, params, [[1, 2, 3]], gen=1)


def test_campaign_entry_points_raise_without_a_card(tmp_path):
    from repro_torch.launch import campaign
    from repro_torch.scenarios import CampaignEngine, build_campaign, run_and_score
    from repro_torch.scenarios.campaign import run_campaign

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_and_score("single_gpu_throttle")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_and_score("single_gpu_throttle", fresh=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_campaign("single_gpu_throttle")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        campaign.main(["--preset", "single_gpu_throttle", "--out", str(tmp_path)])
    spec = build_campaign("single_gpu_throttle", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_campaign(spec, "falcon")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CampaignEngine(spec).run("faults")
    assert not list(tmp_path.iterdir())
