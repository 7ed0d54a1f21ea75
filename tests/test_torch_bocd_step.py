"""The port's BOCD screening step (``repro_torch.kernels.bocd_step``) held
against the JAX package.

* The plain float32 step vs the Pallas ``bocd_step`` in interpret mode, both
  stepped from the same state each tick (rtol 1e-5, atol 1e-6: exp/log differ
  in the last ulps between the two libraries). An entry that is -inf in one
  and finite in the other is allowed only within 1e-4 of log(truncation),
  where the truncation test can flip.
* The ``torch`` backend in float64 vs the float64 numpy ``BatchedBOCD``
  while the frontier is not truncating (rtol 1e-9).
* Twins of the reference's NaN-isolation, truncation-edge and
  ``take_columns`` tests, and the wrapper's CPU dispatch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bocd as ref_bocd
from repro.kernels import bocd_step as ref_bk
from repro_torch.core import bocd
from repro_torch.kernels import bocd_step as bk

TRUNC = 1e-6


def _state_from_jax(det_state, mu0):
    names = ("log_r", "mu", "beta", "kappa", "alpha", "rl")
    arrays = {n: np.asarray(a) for n, a in zip(names, det_state)}
    arrays["mu0"] = np.asarray(mu0)
    from repro_torch.convert import bocd_state_from_numpy

    st = bocd_state_from_numpy(arrays, "cpu", torch.float32)
    return tuple(st[n] for n in names), st["mu0"]


def _assert_close_trunc(got, want, log_trunc, rtol, atol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    flip = np.isinf(got) != np.isinf(want)
    if flip.any():
        finite = np.where(np.isinf(got), want, got)[flip]
        assert np.all(np.abs(finite - log_trunc) <= 1e-4), what
    both = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_allclose(got[both], want[both], rtol=rtol, atol=atol,
                               err_msg=what)
    same = np.isinf(got) & np.isinf(want)
    np.testing.assert_array_equal(got[same], want[same], err_msg=what)


@pytest.mark.parametrize("b", [1, 7, 64])
def test_plain_step_matches_jax_interpret(b):
    """Float32 plain step vs the Pallas kernel (interpret mode) over 12
    ticks with a change, both stepped from the JAX state each tick."""
    k = 16
    det = ref_bk.PallasBOCD(b, max_hypotheses=k, interpret=True)
    state = (det._log_r, det._mu, det._beta, det._kappa, det._alpha, det._rl)
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 0.05, (12, b))
    x[8:] += 0.5  # a change, so growth/truncation/recycling all fire
    log_trunc = float(np.log(np.float32(TRUNC)))
    for t in range(12):
        xs = jnp.asarray(x[t], jnp.float32)
        want = ref_bk.bocd_step(xs, *state, det._mu0, det.hazard,
                                truncation=TRUNC, interpret=True)
        tstate, tmu0 = _state_from_jax(state, det._mu0)
        got = bk.bocd_step_reference(
            torch.tensor(np.asarray(xs)), *tstate, tmu0, det.hazard,
            truncation=TRUNC,
        )
        names = ("log_r", "mu", "beta", "kappa", "alpha", "rl", "p0")
        for n, g, w in zip(names, got, want, strict=True):
            _assert_close_trunc(g.numpy(), np.asarray(w), log_trunc,
                                1e-5, 1e-6, f"tick {t} {n}")
        state = want[:6]


def test_wrapper_runs_plain_version_for_cpu_tensors():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    counts no kernel launch."""
    k, b = 8, 5
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 1.0, (6, b))
    det = bk.TorchBOCD(b, mu0=x[0], max_hypotheses=k, device="cpu",
                       dtype=torch.float32)
    state = (det._log_r, det._mu, det._beta, det._kappa, det._alpha, det._rl)
    before = bk.bocd_step.launches
    for t in range(6):
        xt = torch.as_tensor(x[t], dtype=torch.float32)
        got = bk.bocd_step(xt, *state, det._mu0, 0.01)
        want = bk.bocd_step_reference(xt, *state, det._mu0, 0.01)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
        state = want[:6]
    assert bk.bocd_step.launches == before


@pytest.mark.parametrize("b", [1, 7, 64])
def test_torch_backend_float64_matches_numpy_oracle(b):
    """The ``torch`` backend (float64, CPU) vs the float64 numpy
    BatchedBOCD of the JAX package, while the frontier is not truncating."""
    t_max, k = 24, 32
    rng = np.random.default_rng(2)
    x = rng.normal(1.0, 0.05, (t_max, b))
    x[16:] *= 1.3
    port = bocd.select_backend("torch", device="cpu").make(
        b, mu0=x[0], max_hypotheses=k
    )
    assert port.dtype == torch.float64
    ora = ref_bocd.BatchedBOCD(b, mu0=x[0], max_hypotheses=k)
    for t in range(t_max):
        np.testing.assert_allclose(
            port.update(x[t]), ora.update(x[t]), rtol=1e-9, atol=1e-12
        )
    np.testing.assert_allclose(
        port.p_recent_change(), ora.p_recent_change(), rtol=1e-9, atol=1e-12
    )
    np.testing.assert_array_equal(port.map_runlength(), ora.map_runlength())


@pytest.mark.parametrize("name", ["torch", "cuda"])
def test_nan_isolation(name):
    """NaN observations poison only their own column (twin of the
    reference's kernel NaN-isolation test; the ``cuda`` backend on a CPU
    device runs the plain float32 step)."""
    k, b = 16, 5
    fac = bocd.select_backend(name, device="cpu")
    full = fac.make(b, max_hypotheses=k)
    clean = fac.make(b - 1, max_hypotheses=k)
    rng = np.random.default_rng(1)
    x = rng.normal(1.0, 0.05, (10, b))
    x[3:, -1] = np.nan
    p_full = [full.update(x[t]) for t in range(10)]
    p_clean = [clean.update(x[t, :-1]) for t in range(10)]
    for pf, pc in zip(p_full, p_clean, strict=True):
        assert np.isfinite(pf[:-1]).all()
        np.testing.assert_allclose(pf[:-1], pc, rtol=1e-3, atol=1e-3)
    assert np.isnan(p_full[-1][-1])
    prc = full.p_recent_change()[:-1]
    assert np.isfinite(prc).all() and ((prc >= 0) & (prc <= 1)).all()
    assert (full.map_runlength()[:-1] >= 0).all()


@pytest.mark.parametrize("k", [2, 4])
def test_frontier_truncation_edges(k):
    """Tightest legal slot caps: the victim slot recycles every tick and the
    posterior stays a distribution; the break still registers."""
    b, t_max = 7, 30
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 0.05, (t_max, b))
    x[20:] *= 1.4
    det = bk.CudaBOCD(b, mu0=x[0], max_hypotheses=k, device="cpu")
    p_hist = []
    for t in range(t_max):
        p0 = det.update(x[t])
        p_hist.append(p0)
        assert np.all((p0 >= 0.0) & (p0 <= 1.0))
        lr = det._log_r.to(torch.float64).numpy()
        assert lr.shape[0] == k
        mass = np.exp(lr[np.isfinite(lr).any(axis=1)]).sum(axis=0)
        np.testing.assert_allclose(mass, 1.0, rtol=1e-3)
    p = np.asarray(p_hist)
    assert p[20:23].max() > 2.0 * p[5:20].max()


def test_truncation_edges_match_pallas_backend():
    """At K=2 the port's float32 step follows the Pallas backend tick for
    tick (same victim every tick)."""
    b, t_max, k = 7, 30, 2
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 0.05, (t_max, b))
    x[20:] *= 1.4
    port = bk.CudaBOCD(b, mu0=x[0], max_hypotheses=k, device="cpu")
    pal = ref_bk.PallasBOCD(b, mu0=x[0], max_hypotheses=k, interpret=True)
    for t in range(t_max):
        np.testing.assert_allclose(port.update(x[t]), pal.update(x[t]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(port._rl.numpy(), np.asarray(pal._rl))


def test_take_columns_equals_fresh_slice():
    b = 10
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 0.05, (15, b))
    full = bk.TorchBOCD(b, mu0=x[0], device="cpu")
    keep = np.asarray([0, 3, 7])
    sub = bk.TorchBOCD(keep.size, mu0=x[0, keep], device="cpu")
    for t in range(15):
        full.update(x[t])
        sub.update(x[t, keep])
    full.take_columns(keep)
    assert torch.equal(full._log_r, sub._log_r)
    np.testing.assert_array_equal(full.p_recent_change(), sub.p_recent_change())


def test_retune_resizes_frontier_like_pallas():
    """Shrinking and growing the slot frontier keeps the same rows as the
    reference backend."""
    b = 6
    rng = np.random.default_rng(6)
    x = rng.normal(1.0, 0.05, (20, b))
    port = bk.CudaBOCD(b, mu0=x[0], max_hypotheses=16, device="cpu")
    pal = ref_bk.PallasBOCD(b, mu0=x[0], max_hypotheses=16, interpret=True)
    for t in range(12):
        port.update(x[t])
        pal.update(x[t])
    for cap in (6, 10):
        port.retune(max_hypotheses=cap)
        pal.retune(max_hypotheses=cap)
        np.testing.assert_array_equal(port._rl.numpy(), np.asarray(pal._rl))
        for t in range(12, 16):
            np.testing.assert_allclose(port.update(x[t]), pal.update(x[t]),
                                       rtol=1e-5, atol=1e-6)

