"""The port stands alone: importing ``repro_torch``, running a control
plane tick and serving one smoke-size prefill + decode step load neither
jax nor the JAX package (checked in a fresh interpreter), and the default
entry points want the card."""
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
