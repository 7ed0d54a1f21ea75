"""Tests of the port that need an NVIDIA card: the CUDA kernels against
their plain PyTorch versions, and the kernel-backed fleet screen against the
numpy backend. Each skips without a card; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

This file imports only the port (the card's machine has no jax).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.detector import FleetDetect
from repro_torch.kernels import bocd_step as bk
from repro_torch.kernels import cell_reduce as ck

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close_or_truncation_flip(got, want, rtol, atol, log_trunc):
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    flip = np.isinf(g) != np.isinf(w)
    assert np.all(np.abs(np.where(np.isinf(g), w, g)[flip] - log_trunc) <= 1e-4)
    both = np.isfinite(g) & np.isfinite(w)
    np.testing.assert_allclose(g[both], w[both], rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float64, 1e-12, 1e-12), (torch.float32, 1e-5, 1e-6),
])
def test_bocd_step_kernel_matches_plain_version(card, dtype, rtol, atol):
    k, b = 32, 4096
    rng = np.random.default_rng(8)
    x = rng.normal(0.0, 1.0, (20, b))
    x[10:, ::13] += 5.0
    x[5:, 7] = np.nan
    det = bk.TorchBOCD(b, mu0=x[0], max_hypotheses=k, device=card, dtype=dtype)
    state = (det._log_r, det._mu, det._beta, det._kappa, det._alpha, det._rl)
    log_trunc = float(torch.log(torch.tensor(1e-6, dtype=dtype)))
    before = bk.bocd_step.launches
    for t in range(20):
        xt = torch.as_tensor(x[t], device=card)
        got = bk.bocd_step(xt, *state, det._mu0, 0.01)
        want = bk.bocd_step_reference(xt, *state, det._mu0, 0.01)
        for g, w in zip(got, want, strict=True):
            _close_or_truncation_flip(g, w, rtol, atol, log_trunc)
        state = want[:6]
    assert bk.bocd_step.launches == before + 20


def test_bocd_step_wrapper_rejects_bad_inputs(card):
    det = bk.CudaBOCD(8, device=card)
    args = [torch.zeros(8, device=card), det._log_r, det._mu, det._beta,
            det._kappa, det._alpha, det._rl, det._mu0, 0.01]
    with pytest.raises(ValueError, match="dtype"):
        bk.bocd_step(*args[:1], det._log_r.double(), *args[2:])
    k, b = det._mu.shape
    strided = torch.zeros((b, k), device=card).t()   # (K, B), not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        bk.bocd_step(*args[:2], strided, *args[3:])
    with pytest.raises(ValueError, match="is on"):
        bk.bocd_step(*args[:5], det._kappa.cpu(), *args[6:])


@pytest.mark.parametrize("shape", [(2, 2, 2), (8, 160, 8)])
def test_cell_reduce_kernel_matches_plain_version(card, shape):
    pp, dp, tp = shape
    rng = np.random.default_rng(2)
    host = (rng.uniform(0.5, 1.0, (pp, dp)),
            rng.uniform(5.0, 40.0, (pp, dp, tp)),
            rng.uniform(5.0, 40.0, (pp, dp, tp)),
            rng.uniform(5.0, 40.0, (pp - 1, dp)),
            rng.uniform(1.0, 3.0, (dp,)))
    consts = (3.0, 2.0, 0.7, 1.3, 0.9)
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        arrays = [torch.as_tensor(a, dtype=dt, device=card) for a in host]
        got = ck.cell_reduce(*arrays, *consts)
        want = ck.cell_reduce_reference(*arrays, *consts)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol)


def test_fleet_screen_on_card_flags_like_numpy(card):
    rng = np.random.default_rng(11)
    b, t_max = 512, 80
    x = rng.normal(1.0, 0.01, (t_max, b))
    x[40:, [3, 17, 40, 300]] *= 1.35
    flags = {}
    for name in ("batched", "cuda"):
        fleet = FleetDetect(n_workers=b, backend=name)
        flags[name] = sorted(
            (t, f.worker) for t in range(t_max) for f in fleet.tick(x[t])
        )
    assert flags["cuda"] == flags["batched"]
    assert {w for _, w in flags["batched"]} == {3, 17, 40, 300}
