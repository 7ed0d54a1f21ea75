"""Tests of the port that need an NVIDIA card: the CUDA kernels against
their plain PyTorch versions, the kernel-backed fleet screen against the
numpy backend, and the serve path's kernel route against its plain route.
Each skips without a card; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

This file imports only the port (the card's machine has no jax).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.detector import FleetDetect
from repro_torch.kernels import bocd_step as bk
from repro_torch.kernels import cell_reduce as ck
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import model as model_lib
from repro_torch.models import transformer

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


# Attention kernels against their plain versions, both on the card. The
# reference's tolerances (tests/test_kernels.py:17): float32 differs only in
# summation order, bfloat16 in where the result is rounded.
ATT_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _normal(card, seed, shape, dtype):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=card).to(dtype)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **ATT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,skv,h,kvh,hd,valid", [
    (8, 1088, 32, 8, 128, 1088),   # the serve shape: GQA rep 4
    (2, 384, 8, 1, 64, 100),       # MQA
    (4, 256, 4, 2, 64, [1, 17, 128, 256]),   # per-sequence lengths
    (3, 128, 4, 2, 32, 1),         # one valid position
    (2, 1000, 16, 4, 128, 999),    # Skv not a multiple of a split
    (2, 64, 4, 2, 64, 0),          # nothing valid: zeros
])
def test_flash_decode_kernel_matches_plain_version(card, dtype, b, skv, h, kvh, hd, valid):
    q = _normal(card, 1, (b, h, hd), dtype)
    k = _normal(card, 2, (b, skv, kvh, hd), dtype)
    v = _normal(card, 3, (b, skv, kvh, hd), dtype)
    if isinstance(valid, list):
        valid = torch.tensor(valid, dtype=torch.int32, device=card)
    before = fd.flash_decode.launches
    got = fd.flash_decode(q, k, v, valid)
    want = fd.flash_decode_reference(q, k, v, valid)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, hd)
    _close(got, want, dtype)
    if not isinstance(valid, torch.Tensor) and valid == 0:
        assert not bool(got.float().abs().max())


def test_flash_decode_kernel_reads_a_window_view(card):
    k = _normal(card, 4, (2, 300, 2, 128), torch.bfloat16)
    v = _normal(card, 5, (2, 300, 2, 128), torch.bfloat16)
    q = _normal(card, 6, (2, 8, 128), torch.bfloat16)
    k_win, v_win = k[:, 40:240], v[:, 40:240]
    _close(fd.flash_decode(q, k_win, v_win, 150),
           fd.flash_decode_reference(q, k_win, v_win, 150), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window", [
    (1, 256, 256, 4, 2, 64, True, 0),      # causal, GQA
    (1, 128, 128, 2, 2, 64, False, 0),     # non-causal
    (1, 200, 200, 4, 2, 128, True, 48),    # sliding window
    (2, 130, 130, 4, 4, 128, True, 0),     # Sq not a multiple of the tile
    (1, 96, 160, 8, 1, 64, False, 0),      # MQA, Sq != Skv
])
def test_flash_attention_kernel_matches_plain_version(card, dtype, b, sq, skv, h, kvh, hd,
                                                      causal, window):
    q = _normal(card, 7, (b, sq, h, hd), dtype)
    k = _normal(card, 8, (b, skv, kvh, hd), dtype)
    v = _normal(card, 9, (b, skv, kvh, hd), dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, sq, h, hd)
    _close(got, want, dtype)


def test_attention_wrappers_reject_what_the_kernels_do_not_take(card):
    q = _normal(card, 10, (2, 4, 48), torch.float32)
    k = _normal(card, 11, (2, 16, 2, 48), torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fd.flash_decode(q, k, k, 4)
    q = _normal(card, 10, (2, 4, 64), torch.float16)
    k = _normal(card, 11, (2, 16, 2, 64), torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fd.flash_decode(q, k, k, 4)
    q = _normal(card, 12, (1, 16, 4, 64), torch.float32)
    k = _normal(card, 13, (1, 16, 2, 64), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3), k)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention(q, k.cpu(), k)


@pytest.mark.parametrize("arch", ["granite-3-8b", "mistral-nemo-12b"])
def test_decode_and_forward_kernel_routes_match_plain_routes(card, arch):
    cfg = get_config(arch).smoke()
    params = model_lib.init_params(cfg, 0, device=card)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 64)), device=card)
    with torch.no_grad():
        want, _ = model_lib.forward(params, {"tokens": tokens}, cfg)
        got, _ = model_lib.forward(params, {"tokens": tokens}, cfg, use_kernel=True)
        _close(got, want, torch.bfloat16)
        caches = transformer.init_caches(cfg, 2, 80, device=card)
        tok = tokens[:, :1]
        for pos in range(12):
            plain = {s: {n: t.clone() for n, t in c.items()} for s, c in caches.items()}
            want, _ = model_lib.decode_step(params, tok, plain, pos, cfg)
            got, caches = model_lib.decode_step(params, tok, caches, pos, cfg,
                                                use_kernel=True)
            _close(got, want, torch.bfloat16)
            tok = torch.argmax(want[:, -1], dim=-1).reshape(2, 1)
