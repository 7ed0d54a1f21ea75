"""The four example twins (``examples/torch_*.py``) on the CPU against the
JAX package's examples.

* ``torch_detect_from_trace``: the reference's lines, line for line.
* ``torch_quickstart`` and ``torch_train_100m_falcon``: the strategy
  timeline, the iteration times and FALCON's events equal the reference
  example's. The timeline comes from the simulator, the injector and the
  control plane alone, so the reference examples and the twins run with
  their model step replaced by one that only counts steps (the train twin
  on its ``--smoke`` model); the card trains both twins' models
  (``chip_smoke.py`` phase 17), and so does the ``slow`` test below at full
  width on the CPU.
* ``torch_serve_decode``: the generated tokens equal the reference
  example's on the reference's initial weights, carried over, in float32
  (in bfloat16 a near-tie of two logits may break either way).

A full-width CPU run of the train twin is marked ``slow``.
"""
import contextlib
import importlib.util
import io
import os
import re
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jconfigs
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch.configs import base as tconfigs
from repro_torch.convert import params_from_numpy

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def _counting(loss_of_step):
    def make_train_step(cfg, opt_cfg, **_):
        def step(params, opt_state, batch):
            loss = 1000.0 - loss_of_step(opt_state.step)
            return params, opt_state._replace(step=opt_state.step + 1), {"loss": loss}
        return step
    return make_train_step


@pytest.fixture
def counting_step(monkeypatch):
    """The reference trainer's model step replaced by one that only counts
    steps (a loss that falls by 1 a step), its parameters by the smoke
    config's and its disk checkpoint by a no-op: the timeline does not read
    the model."""
    init = jmodel.init_params
    monkeypatch.setattr(jts, "make_train_step", _counting(lambda s: s.astype(jnp.float32)))
    monkeypatch.setattr(jmodel, "init_params", lambda cfg, seed=0: init(cfg.smoke(), seed))
    monkeypatch.setattr(jckpt.CheckpointManager, "save_disk", lambda self, tree, step: 0.0)


@pytest.fixture
def counting_twin_step(monkeypatch):
    """The same for the port's trainer (its checkpoint is written)."""
    from repro_torch.train import train_step as tts

    monkeypatch.setattr(tts, "make_train_step", _counting(lambda s: s.float()))


def test_detect_from_trace_twin_prints_the_reference_lines():
    want = run(load("detect_from_trace").main)
    got = run(load("torch_detect_from_trace").main)
    assert got == want and got[-1] == "detect_from_trace OK"


def _timeline(lines):
    """The quickstart table without its loss column, and the event lines."""
    out = []
    for line in lines:
        m = re.match(r"^\s*(\d+)\s+\S+\s+(\S+)\s*(\S*)$", line)
        if m:
            out.append(m.groups())
        elif line.startswith(("FALCON-DETECT", "quickstart OK")):
            out.append(line)
    return out


def test_quickstart_twin_matches_reference_timeline(counting_step, counting_twin_step):
    want = run(load("quickstart").main)
    got = run(load("torch_quickstart").main, ["--device", "cpu"])
    assert _timeline(got) == _timeline(want)
    assert any("ADJUST_MICROBATCH" in str(row) for row in _timeline(got))
    assert any(str(row).startswith("FALCON-DETECT") for row in _timeline(got))


def test_train_twin_matches_reference_timeline(counting_step, counting_twin_step, monkeypatch,
                                               tmp_path):
    monkeypatch.setattr(sys, "argv", ["train_100m_falcon.py", "--steps", "200"])
    want = run(load("train_100m_falcon").main)
    got = run(load("torch_train_100m_falcon").main,
              ["--device", "cpu", "--smoke", "--seq-len", "16", "--ckpt-dir", str(tmp_path)])

    def plan(lines):
        return [line for line in lines
                if line.startswith(("iteration time:", "total wall", "  step ", "detected:"))]

    assert plan(got) == plan(want)
    assert any(line.startswith("detected: gpu_degradation") for line in plan(got))
    assert got[-1] == "train_100m_falcon OK"
    assert (tmp_path / "ckpt_00000200.npz").exists()


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b"])
def test_serve_decode_twin_generates_the_reference_tokens(monkeypatch, arch):
    jex, tex = load("serve_decode"), load("torch_serve_decode")
    cfg_j = replace(jconfigs.get_config(arch).smoke(), dtype="float32")
    cfg_t = replace(tconfigs.get_config(arch).smoke(), dtype="float32")
    params = jax.tree.map(lambda a: a.astype(jnp.float32), jmodel.init_params(cfg_j, 0))

    class Smoke:
        def smoke(self):
            return cfg_j

    monkeypatch.setattr(jex, "get_config", lambda name: Smoke())
    monkeypatch.setattr(jex.model_lib, "init_params", lambda cfg, seed: params)
    want = run(jex.serve, arch)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got = run(lambda: tex.serve(arch, device="cpu", cfg=cfg_t, params=tparams))
    assert got == want and "sample row" in got[0]


def test_serve_decode_twin_runs_on_the_cpu():
    lines = run(load("torch_serve_decode").main, ["--device", "cpu"])
    assert lines[-1] == "serve_decode OK" and len(lines) == 3


def test_twins_want_the_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ("torch_quickstart", "torch_serve_decode"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(name).main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("torch_train_100m_falcon").main(["--steps", "1"])


@pytest.mark.slow
def test_train_twin_at_full_width_on_the_cpu(counting_step, monkeypatch, tmp_path):
    monkeypatch.setattr(sys, "argv", ["train_100m_falcon.py", "--steps", "200"])
    want = run(load("train_100m_falcon").main)
    got = run(load("torch_train_100m_falcon").main,
              ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert [line for line in got if line.startswith("  step ")] == [
        line for line in want if line.startswith("  step ")]
    assert got[0] == want[0]       # the model line: the same parameter count
