"""Tests of the port that need an NVIDIA card: the CUDA kernels against
their plain PyTorch versions, the kernel-backed fleet screen against the
numpy backend, the serve path's kernel route against its plain route, an
MoE layer on the card against the CPU, the what-if layer's committed
attribution sidecar regenerated on the card, and the mesh checks of
``chip_smoke.py`` (4 ranks over gloo on the card) at smoke size.
Each skips without a card; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

This file imports only the port (the card's machine has no jax).
"""
import time

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

#: host seconds between a traced session's edges and the calls it traces
TRACE_MARGIN_S = 0.05


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
    k = bk._max_slots(4, card.index or 0) + 1   # more slots than shared memory holds
    big = bk.TorchBOCD(8, max_hypotheses=k, device=card, dtype=torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        bk.bocd_step(args[0], big._log_r, big._mu, big._beta, big._kappa, big._alpha,
                     big._rl, big._mu0, 0.01)


BOCD_EDGE_CASES = ["dead slot", "tie, smallest run length", "tie, smallest slot",
                   "NaN stream"]


def _bocd_edge_state(card, dtype, b, case):
    """A (K = 8, B) state for one victim rule, and the victim it must pick
    (None: whatever the reference picks)."""
    k = 8
    rng = np.random.default_rng(3)
    w = rng.uniform(0.2, 1.0, (k, b))
    log_r = np.log(w / w.sum(0))
    mu = rng.normal(0.0, 1.0, (k, b))
    beta = rng.uniform(0.5, 2.0, (k, b))
    rl = np.array([[3], [1], [1], [5], [4], [2], [6], [0]])
    x = rng.normal(0.0, 1.0, b)
    expect = None
    if case == "dead slot":            # an all -inf row is recycled first
        log_r[6] = -np.inf
        expect = 6
    elif case.startswith("tie"):       # equal weakest rows: the same strength
        tied = (1, 2, 7) if case == "tie, smallest run length" else (1, 2)
        for s in tied:
            log_r[s], mu[s], beta[s] = np.log(1e-3), mu[1], beta[1]
        expect = 7 if len(tied) == 3 else 1
    else:
        x[min(7, b - 1)] = np.nan
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=card)  # noqa: E731
    state = (t(log_r), t(mu), t(beta), t(np.full((k, 1), 3.0)), t(np.full((k, 1), 2.0)),
             t(rl, torch.int32))
    return t(x), state, t(rng.normal(0.0, 1.0, b)), expect


@pytest.mark.parametrize("case", BOCD_EDGE_CASES)
# 1,000: not a multiple of the columns a block takes a pass (128 at K = 8,
# bocd_step_columns_per_block).
@pytest.mark.parametrize("b", [1, 1000])
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float64, 1e-12, 1e-12), (torch.float32, 1e-5, 1e-6),
])
def test_bocd_step_victim_rules_and_edges(card, dtype, rtol, atol, b, case):
    x, state, mu0, expect = _bocd_edge_state(card, dtype, b, case)
    got = bk.bocd_step(x, *state, mu0, 0.01)
    want = bk.bocd_step_reference(x, *state, mu0, 0.01)
    log_trunc = float(torch.log(torch.tensor(1e-6, dtype=dtype)))
    for g, w in zip(got, want, strict=True):
        _close_or_truncation_flip(g, w, rtol, atol, log_trunc)
    victim = int(torch.nonzero(got[5][:, 0] == 0)[0, 0])
    assert victim == int(torch.nonzero(want[5][:, 0] == 0)[0, 0])
    if expect is not None:
        assert victim == expect
    if case == "NaN stream":
        col = min(7, b - 1)
        assert bool(torch.isnan(got[0][:, col]).all())
        if b > 1:
            assert not bool(torch.isnan(got[0][:, col - 1]).any())


@pytest.mark.parametrize("k,b", [
    (129, 1000),     # one row past the 128 a column's threads hold at a time
    (200, 1000),
    (256, 16384),    # FleetDetect's adaptive cap at its upper bound
    (700, 300),      # more slots than a block has threads; shared-memory opt-in
])
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float64, 1e-12, 1e-12), (torch.float32, 1e-5, 1e-6),
])
def test_bocd_step_kernel_takes_any_slot_count(card, dtype, rtol, atol, k, b):
    """Every slot live (random posteriors), so the victim pick and the
    row-order sums run over all K rows."""
    rng = np.random.default_rng(k)
    w = rng.uniform(0.2, 1.0, (k, b))
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=card)  # noqa: E731
    state = (t(np.log(w / w.sum(0))), t(rng.normal(0.0, 1.0, (k, b))),
             t(rng.uniform(0.5, 2.0, (k, b))), t(rng.uniform(1.0, 5.0, (k, 1))),
             t(rng.uniform(1.0, 3.0, (k, 1))), t(rng.permutation(k)[:, None], torch.int32))
    mu0 = t(rng.normal(0.0, 1.0, b))
    log_trunc = float(torch.log(torch.tensor(1e-6, dtype=dtype)))
    for tick in range(4):
        x = rng.normal(0.0, 1.0, b)
        if tick == 2:
            x[b // 2] = np.nan   # one stream goes NaN
        got = bk.bocd_step(t(x), *state, mu0, 0.01)
        want = bk.bocd_step_reference(t(x), *state, mu0, 0.01)
        for g, w in zip(got, want, strict=True):
            _close_or_truncation_flip(g, w, rtol, atol, log_trunc)
        assert torch.equal(got[5], want[5])   # the same victim
        state = want[:6]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 16384])
def test_bocd_step_is_one_kernel_per_call(card, dtype, b):
    x = np.random.default_rng(5).normal(0.0, 1.0, (2, b))
    det = bk.TorchBOCD(b, mu0=x[0], max_hypotheses=32, device=card, dtype=dtype)
    state = (det._log_r, det._mu, det._beta, det._kappa, det._alpha, det._rl)
    xt = torch.as_tensor(x[1], dtype=dtype, device=card)
    _assert_one_kernel_per_call(lambda: bk.bocd_step(xt, *state, det._mu0, 0.01), "bocd_kernel")


# The narrow kernel takes pp, tp <= 16; (20, 24, 4), (3, 5, 17) and (4, 12, 40)
# take the general one (tp 40: rings in chunks of 32); (2, 4, 2) is the
# (2 TP, 4 DP, 2 PP) job of examples/torch_train_100m_falcon.py.
CELL_SHAPES = [(2, 2, 2), (1, 3, 5), (3, 1, 2), (9, 9, 3), (8, 160, 8), (16, 128, 8),
               (16, 1024, 8), (20, 24, 4), (3, 5, 17), (4, 12, 40), (2, 4, 2)]
CELL_CONSTS = (3.0, 2.0, 0.7, 1.3, 0.9)


def _cell_arrays(shape, seed=2):
    pp, dp, tp = shape
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, (pp, dp)),
            rng.uniform(5.0, 40.0, (pp, dp, tp)),
            rng.uniform(5.0, 40.0, (pp, dp, tp)),
            rng.uniform(5.0, 40.0, (pp - 1, dp)),
            rng.uniform(1.0, 3.0, (dp,)))


def _cell_packed(card, host, shape, dtype):
    buf = np.zeros(ck.packed_layout(*shape)[1])
    ck.pack_cells(buf, host, shape)
    out = torch.empty(ck.out_size(*shape), dtype=dtype, device=card)
    ck.cell_reduce_packed(torch.as_tensor(buf, device=card), shape, *CELL_CONSTS, out=out)
    return ck.split_out(out, shape)


@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_cell_reduce_kernel_matches_plain_version(card, shape):
    """Both entries against the plain version, in float32 and float64: both
    kernels (narrow and general), a ragged last block of the cluster, one
    block, and (16, 1024, 8), whose blocks take 128 dp columns each."""
    pp, dp, tp = shape
    host = _cell_arrays(shape)
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        arrays = [torch.as_tensor(a, dtype=dt, device=card) for a in host]
        want = ck.cell_reduce_reference(*arrays, *CELL_CONSTS)
        for got in (ck.cell_reduce(*arrays, *CELL_CONSTS),
                    _cell_packed(card, host, shape, dt)):
            for g, w in zip(got, want, strict=True):
                assert g.dtype == dt and g.shape == w.shape
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol)


@pytest.mark.parametrize("shape", [(8, 160, 8), (20, 24, 4)])
def test_cell_reduce_nan_in_a_tp_edge_propagates(card, shape):
    """A NaN edge: that cell's tp_bw, its column's stage_max and t are NaN,
    nothing else (jnp.min / jnp.max semantics), on both entries and both
    kernels."""
    host = _cell_arrays(shape, seed=5)
    host[1][3, 17, 2] = np.nan
    for dt in (torch.float32, torch.float64):
        arrays = [torch.as_tensor(a, dtype=dt, device=card) for a in host]
        want = ck.cell_reduce_reference(*arrays, *CELL_CONSTS)
        for got in (ck.cell_reduce(*arrays, *CELL_CONSTS),
                    _cell_packed(card, host, shape, dt)):
            t, stage_max, tp_bw, dp_bw = (g.cpu() for g in got)
            assert bool(t.isnan().all()) and bool(stage_max[0, 17].isnan())
            assert int(stage_max.isnan().sum()) == 1
            assert bool(tp_bw[3, 17].isnan()) and int(tp_bw.isnan().sum()) == 1
            assert not bool(dp_bw.isnan().any())
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g.isnan(), w.isnan())


def test_cell_reduce_packed_evaluation_equals_unpacked_float32_route(card):
    """``CudaReduction``'s evaluation (one upload of the packed float64
    cells, one launch, one download) is bit-equal to five float32 copies,
    the kernel and a concatenated download."""
    from repro_torch.cluster.simulator import CudaReduction

    shape = (8, 160, 8)
    host = _cell_arrays(shape, seed=9)
    rb = CudaReduction(card)
    got = rb.evaluate(host, CELL_CONSTS, shape)
    ins = [torch.as_tensor(a).to(card, torch.float32) for a in host]
    want = torch.cat([r.reshape(-1) for r in ck.cell_reduce(*ins, *CELL_CONSTS)])
    assert np.array_equal(got, want.double().cpu().numpy())
    assert rb.copies == 1 and rb.copy_bytes == 8 * ck.packed_layout(*shape)[1]


# adapt_every = 10 retunes max_hypotheses from the flag rate: on this quiet
# fleet the cap reaches cap_bounds[1] = 256 at the first retune, above the
# 128 slots whose rows the kernel keeps in registers.
@pytest.mark.parametrize("adapt_every", [0, 10])
def test_fleet_screen_on_card_flags_like_numpy(card, adapt_every):
    rng = np.random.default_rng(11)
    b, t_max = 512, 80
    x = rng.normal(1.0, 0.01, (t_max, b))
    x[40:, [3, 17, 40, 300]] *= 1.35
    flags = {}
    for name in ("batched", "cuda"):
        fleet = FleetDetect(n_workers=b, backend=name, adapt_every=adapt_every)
        found = []
        for t in range(t_max):
            if t == 20:
                cap, before = fleet.max_hypotheses, bk.bocd_step.launches
            found += [(t, f.worker) for f in fleet.tick(x[t])]
        flags[name] = sorted(found)
    assert cap == (256 if adapt_every else 32)
    assert bk.bocd_step.launches > before   # the kernel ran at that cap
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
    (8, 1088, 16, 16, 128, 1088),  # MHA, rep 1: the OLMoE serve shape
    (8, 1088, 8, 2, 128, 1025),    # a rank of granite-3-8b's decode over model 4
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


# Tile-boundary sweep of flash_attention: sequence lengths on both sides of
# the 16-row fragments of a warp, the 64-row tiles (a bf16 warpgroup's, the
# float32 blocks'), the 64/128-key tiles and the 128-row bf16 blocks,
# under each mask, at both head dims and three GQA ratios, in bf16 and
# float32.
ATT_SWEEP_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000]
ATT_SWEEP_MASKS = [(True, 0), (False, 0), (True, 48)]   # causal, non-causal, window 48


@pytest.mark.parametrize("causal,window", ATT_SWEEP_MASKS)
@pytest.mark.parametrize("s", ATT_SWEEP_LENGTHS)
def test_flash_attention_tile_boundary_sweep(card, s, causal, window):
    h = 4
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (64, 128):
            for kvh in (1, 2, h):
                q = _normal(card, 20 + s, (1, s, h, hd), dtype)
                k = _normal(card, 21 + s, (1, s, kvh, hd), dtype)
                v = _normal(card, 22 + s, (1, s, kvh, hd), dtype)
                got = fa.flash_attention(q, k, v, causal=causal, window=window)
                want = fa.flash_attention_reference(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", ATT_SWEEP_MASKS)
def test_flash_attention_sweep_with_sq_not_skv(card, dtype, causal, window):
    q = _normal(card, 30, (2, 129, 8, 128), dtype)
    k = _normal(card, 31, (2, 1000, 2, 128), dtype)
    v = _normal(card, 32, (2, 1000, 2, 128), dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_reference(q, k, v, causal=causal, window=window)
    _close(got, want, dtype)


# valid_len sweep of flash_decode across the split (128 positions) and
# cluster (8 splits) boundaries, as an int and as a per-sequence tensor
# with zeros among the lengths.
DECODE_SKV = 1536
DECODE_SWEEP = [0, 1, 127, 128, 129, 1023, 1088, DECODE_SKV]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_decode_valid_len_sweep(card, dtype, hd):
    b, h, kvh = len(DECODE_SWEEP), 8, 2
    q = _normal(card, 40, (b, h, hd), dtype)
    k = _normal(card, 41, (b, DECODE_SKV, kvh, hd), dtype)
    v = _normal(card, 42, (b, DECODE_SKV, kvh, hd), dtype)
    for valid in DECODE_SWEEP:
        got = fd.flash_decode(q, k, v, valid)
        _close(got, fd.flash_decode_reference(q, k, v, valid), dtype)
        if valid == 0:
            assert not bool(got.float().abs().max())
    lens = torch.tensor(DECODE_SWEEP, dtype=torch.int32, device=card)
    got = fd.flash_decode(q, k, v, lens)
    _close(got, fd.flash_decode_reference(q, k, v, lens), dtype)
    assert not bool(got[0].float().abs().max())
    assert bool(got[1:].float().abs().amax(dim=(1, 2)).gt(0).all())


def _cuda_kernels(fn, calls=1):
    """Names of the CUDA kernels that ``calls`` calls of ``fn`` ran, from
    torch.profiler. Sleep kernels bracket the calls and are left out of the
    names. A throwaway profiler session around one call comes first, so
    that CUPTI is set up before the traced one. The traced calls then sit
    TRACE_MARGIN_S of host time inside the session on both sides: in a
    card test run that had just built the kernels, the profiler dropped
    kernels of a session that had no such margin (2 of 3 at a time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()   # built and bound before the traced calls
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name]


def _assert_one_kernel_per_call(fn, part):
    """Three traced calls run three kernels named with ``part`` (two when
    the profiler misses one) and nothing else."""
    names = _cuda_kernels(fn, calls=3)
    assert len(names) in (2, 3) and all(part in n for n in names), names


@pytest.mark.parametrize("shape", [(8, 160, 8), (16, 1024, 8)])
def test_cell_reduce_is_one_kernel_per_call(card, shape):
    host = _cell_arrays(shape)
    arrays = [torch.as_tensor(a, dtype=torch.float32, device=card) for a in host]
    _assert_one_kernel_per_call(lambda: ck.cell_reduce(*arrays, *CELL_CONSTS), "cell_reduce")
    buf = np.zeros(ck.packed_layout(*shape)[1])
    ck.pack_cells(buf, host, shape)
    cells = torch.as_tensor(buf, device=card)
    out = torch.empty(ck.out_size(*shape), dtype=torch.float32, device=card)
    _assert_one_kernel_per_call(
        lambda: ck.cell_reduce_packed(cells, shape, *CELL_CONSTS, out=out), "cell_reduce")


@pytest.mark.parametrize("valid", ["int", "tensor"])
def test_flash_decode_is_one_kernel_per_call(card, valid):
    q = _normal(card, 50, (8, 32, 128), torch.bfloat16)
    k = _normal(card, 51, (8, 1088, 8, 128), torch.bfloat16)
    v = _normal(card, 52, (8, 1088, 8, 128), torch.bfloat16)
    lens = 1088 if valid == "int" else torch.full((8,), 1088, dtype=torch.int32, device=card)
    _assert_one_kernel_per_call(lambda: fd.flash_decode(q, k, v, lens), "decode_kernel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_one_kernel_per_call(card, dtype):
    q = _normal(card, 53, (1, 512, 32, 128), dtype)
    k = _normal(card, 54, (1, 512, 8, 128), dtype)
    v = _normal(card, 55, (1, 512, 8, 128), dtype)
    _assert_one_kernel_per_call(lambda: fa.flash_attention(q, k, v, causal=True), "attention")


def test_attention_kernels_launch_on_every_card(card):
    """The shared-memory opt-in of the attention kernels is kept per device:
    after launches on the first card, each kernel (bf16 and float32
    flash_attention above 48 KB of shared memory, flash_decode) still
    launches on every other card. One card cannot show the fault."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards: the opt-in is kept per device")
    for i in range(n):
        dev = torch.device("cuda", i)
        for dtype in (torch.bfloat16, torch.float32):
            q = _normal(dev, 60, (1, 256, 8, 128), dtype)
            k = _normal(dev, 61, (1, 256, 2, 128), dtype)
            v = _normal(dev, 62, (1, 256, 2, 128), dtype)
            _close(fa.flash_attention(q, k, v, causal=True),
                   fa.flash_attention_reference(q, k, v, causal=True), dtype)
            q = _normal(dev, 63, (8, 32, 128), dtype)
            k = _normal(dev, 64, (8, 1088, 8, 128), dtype)
            v = _normal(dev, 65, (8, 1088, 8, 128), dtype)
            _close(fd.flash_decode(q, k, v, 1000),
                   fd.flash_decode_reference(q, k, v, 1000), dtype)


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


# The SSD scan against its plain version (the sequential recurrence), both
# on the card, with the reference's tolerances (tests/test_kernels.py:98):
# float32 differs in summation order, bfloat16 also in where y is rounded.
SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
           torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
SSD_CASES = [   # b, s, h, p, g, n, chunk, dt scale
    (1, 64, 2, 32, 1, 16, 16, 0.5),
    (2, 128, 4, 64, 2, 32, 32, 0.5),      # two groups
    (1, 96, 2, 16, 1, 8, 32, 0.5),        # three chunks, P below a block's 32
    (1, 4096, 80, 64, 1, 128, 128, 0.5),  # mamba2-2.7b's forward shape
    # dt 100x smaller: the state decays by ~e^-0.5 a chunk and reaches all
    # 32 chunks (the reference's dt forgets it within one chunk)
    (1, 4096, 80, 64, 1, 128, 128, 0.005),
]
# Each bf16 row of y (the P values of one (b, t, h)) to a relative L2 error:
# sound rows read a few 1e-3, a scan that drops the state entering a chunk
# reads far above (chip_smoke.py, phase 3).
SSD_ROW_REL = 2e-2


def _ssd_inputs(card, shape, dtype, seed=20):
    b, s, h, p, g, n, _, dt_scale = shape
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(b, s, h, p)), dtype=torch.float32, device=card)
    dt = torch.nn.functional.softplus(torch.as_tensor(
        rng.normal(size=(b, s, h)), dtype=torch.float32, device=card)) * dt_scale
    a = -torch.exp(torch.as_tensor(rng.normal(size=(h,)), dtype=torch.float32,
                                   device=card) * 0.2)
    bm = torch.as_tensor(rng.normal(size=(b, s, g, n)), dtype=torch.float32, device=card)
    cm = torch.as_tensor(rng.normal(size=(b, s, g, n)), dtype=torch.float32, device=card)
    return x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_CASES)
def test_ssd_scan_kernel_matches_plain_version(card, dtype, shape):
    from repro_torch.kernels import ssd_scan as sk

    x, dt, a, bm, cm = _ssd_inputs(card, shape, dtype)
    before = sk.ssd_scan.launches
    y, st = sk.ssd_scan(x, dt, a, bm, cm, chunk=shape[6])
    y_r, st_r = sk.ssd_scan_reference(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    assert sk.ssd_scan.launches == before + 1
    assert y.dtype == dtype and st.dtype == dtype
    assert y.shape == x.shape and st.shape == st_r.shape
    for got, want in ((y, y_r), (st, st_r)):
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **SSD_TOL[dtype])
    if dtype == torch.bfloat16:
        g = y.double().reshape(-1, y.shape[-1])
        w = y_r.double().reshape(-1, y.shape[-1])
        assert float(((g - w).norm(dim=1) / w.norm(dim=1)).max()) <= SSD_ROW_REL


def test_ssd_scan_bf16_runs_the_three_kernels_of_its_design(card):
    """One bf16 call from the model (dt in bf16) runs the library's chunk
    states, state passing and outputs kernels, and nothing else: no cast,
    no cuBLAS."""
    from repro_torch.kernels import ssd_scan as sk

    x, dt, a, bm, cm = _ssd_inputs(card, SSD_CASES[3], torch.bfloat16)
    dt = dt.to(torch.bfloat16)
    design = ["ssd_chunk_state", "ssd_state_pass", "ssd_chunk_output"]
    # Three calls traced: the design's sequence three times, or with one
    # launch that the profiler missed.
    names = _cuda_kernels(lambda: sk.ssd_scan(x, dt, a, bm, cm, chunk=128), calls=3)
    short = [n.replace("(anonymous namespace)::", "").split("(")[0].split()[-1] for n in names]
    seq = design * 3
    assert short == seq or any(short == seq[:i] + seq[i + 1:] for i in range(9)), names


def test_ssd_scan_kernel_reads_strided_b_and_c(card):
    """B and C as the model makes them: two halves of one projection."""
    from repro_torch.kernels import ssd_scan as sk

    x, dt, a, bm, cm = _ssd_inputs(card, (2, 64, 4, 32, 2, 16, 32, 0.5), torch.bfloat16, 3)
    bc = torch.cat([bm, cm], dim=-1)
    b_view, c_view = torch.split(bc, bm.shape[-1], dim=-1)
    assert not b_view.is_contiguous()
    y, st = sk.ssd_scan(x, dt.to(torch.bfloat16), a, b_view, c_view, chunk=32)
    y_r, st_r = sk.ssd_scan_reference(x, dt.to(torch.bfloat16), a, bm, cm)
    for got, want in ((y, y_r), (st, st_r)):
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **SSD_TOL[torch.bfloat16])


def test_ssd_scan_raises_under_autograd_and_on_bad_inputs(card):
    from repro_torch.kernels import ssd_scan as sk

    x, dt, a, bm, cm = _ssd_inputs(card, SSD_CASES[0], torch.float32)
    before = sk.ssd_scan.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        sk.ssd_scan(x.requires_grad_(True), dt, a, bm, cm, chunk=16)
    x = x.detach()
    with pytest.raises(ValueError, match="chunk"):
        sk.ssd_scan(x, dt, a, bm, cm, chunk=24)
    with pytest.raises(ValueError, match="dtype"):
        sk.ssd_scan(x, dt, a, bm.double(), cm, chunk=16)
    with pytest.raises(ValueError, match="is on"):
        sk.ssd_scan(x, dt, a, bm.cpu(), cm, chunk=16)
    assert sk.ssd_scan.launches == before
    with torch.no_grad():
        sk.ssd_scan(x.requires_grad_(True), dt, a, bm, cm, chunk=16)
    assert sk.ssd_scan.launches == before + 1


def test_mamba2_forward_launches_ssd_scan_once_per_layer(card):
    """mamba2-2.7b at its published width (64 layers): a forward with
    ``use_kernel`` launches ``ssd_scan`` 64 times, and its logits follow
    the plain chunked route's."""
    from repro_torch.kernels import ssd_scan as sk

    cfg = get_config("mamba2-2.7b")
    params = model_lib.init_params(cfg, 0, device=card)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 256)),
                             device=card)
    with torch.no_grad():
        before = sk.ssd_scan.launches
        got, _ = model_lib.forward(params, {"tokens": tokens}, cfg, use_kernel=True)
        torch.cuda.synchronize()
        assert sk.ssd_scan.launches - before == cfg.num_layers == 64
        want, _ = model_lib.forward(params, {"tokens": tokens}, cfg)
    assert bool(torch.isfinite(got.float()).all())
    real = slice(0, cfg.vocab_size)
    agree = (got[..., real].argmax(-1) == want[..., real].argmax(-1)).float().mean()
    assert float(agree) > 0.5
    del params
    torch.cuda.empty_cache()


def test_mamba2_smoke_kernel_route_matches_plain_route_and_decode(card):
    cfg = get_config("mamba2-2.7b").smoke()
    params = model_lib.init_params(cfg, 0, device=card)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)),
                             device=card)
    with torch.no_grad():
        want, _ = model_lib.forward(params, {"tokens": tokens}, cfg)
        got, _ = model_lib.forward(params, {"tokens": tokens}, cfg, use_kernel=True)
        _close(got, want, torch.bfloat16)
        caches = transformer.init_caches(cfg, 2, 64, device=card)
        for pos in range(8):
            logits, caches = model_lib.decode_step(params, tokens[:, pos:pos + 1], caches,
                                                   pos, cfg)
            assert bool(torch.isfinite(logits.float()).all())


def _decisions(event_log):
    """The decisions of a report's event log: type, job, time, change-point
    index, root cause, components, strategy and status of each flag,
    diagnosis, mitigation action and result."""
    keys = []
    for rec in event_log:
        kind = rec["type"]
        if kind not in ("Flag", "Diagnosis", "MitigationAction", "MitigationResult"):
            continue
        event = rec.get("event") or {}
        keys.append((
            kind, rec["job_id"], rec["time"],
            (rec.get("change_point") or {}).get("index"),
            event.get("root_cause"), tuple(event.get("components", ())),
            rec.get("strategy"), rec.get("status"), rec.get("applied"),
            rec.get("resolved"), rec.get("deduped_from"),
        ))
    return keys


def test_campaign_on_card_decides_like_the_committed_report(card):
    """single_gpu_throttle -j1 on the card (the engine, the CUDA bocd_step
    screen in float32): the decisions and the scoring blocks of the
    committed report, launched through the kernel."""
    import json
    import os

    from repro_torch.scenarios import run_and_score

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "results", "campaigns", "single_gpu_throttle-j1-s0.json")
    with open(path) as f:
        want = json.load(f)
    before = bk.bocd_step.launches
    _, _, got = run_and_score("single_gpu_throttle", n_jobs=1, seed=0)
    assert bk.bocd_step.launches > before
    assert _decisions(got["event_log"]) == _decisions(want["event_log"])
    assert _decisions(want["event_log"])
    for block in ("detection", "mitigation", "episodes", "diagnoses"):
        assert got[block] == want[block], block


@pytest.mark.parametrize("t", [8, 256])
def test_moe_layer_on_card_equals_cpu_plain_version(card, t):
    """One MoE layer (64 experts, top 8, capacity 1.25: the OLMoE router's
    shape at a narrow width) on the card and on the CPU in float32, from
    the same weights and tokens: the same routing and kept mask, outputs
    within float32 summation order; two card runs give the same bits (the
    combine adds in a fixed order, no atomics). t = 8 is a decode step,
    where capacity 2 drops most choices."""
    from dataclasses import replace

    from repro_torch.models import layers, moe

    cfg = replace(get_config("olmoe-1b-7b").smoke(), dtype="float32", num_experts=64,
                  top_k=8, moe_d_ff=64)
    rng = np.random.default_rng(11)
    host = {name: torch.as_tensor(rng.normal(size=pdef.shape) / np.sqrt(pdef.shape[-2]),
                                  dtype=torch.float32)
            for name, pdef in moe.moe_schema(cfg).items() if name != "norm"}
    host["norm"] = torch.ones(cfg.d_model)
    x = torch.as_tensor(rng.normal(size=(1, t, cfg.d_model)), dtype=torch.float32)
    dev = {name: v.to(card) for name, v in host.items()}

    def plan(params, xs):
        hn = layers.rmsnorm(xs, params["norm"], cfg.norm_eps).reshape(t, -1)
        _, idx, _ = moe.route(hn @ params["router"], cfg.top_k, n_real=cfg.num_experts)
        order, _, _, keep, _ = moe.dispatch(idx, cfg)
        return idx.cpu(), order.cpu(), keep.cpu()

    with torch.no_grad():
        want, aux_want = moe.apply_moe(host, x, cfg)
        got, aux = moe.apply_moe(dev, x.to(card), cfg)
        again, _ = moe.apply_moe(dev, x.to(card), cfg)
        plan_cpu, plan_card = plan(host, x), plan(dev, x.to(card))
    for a, b in zip(plan_card, plan_cpu):
        assert torch.equal(a, b)
    keep = plan_card[2]
    assert bool(keep.any()) and (t > 8 or not bool(keep.all()))
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-6)


def test_whatif_leave_one_out_on_card_equals_committed_sidecar(card, tmp_path, monkeypatch):
    """``python -m repro_torch.launch.whatif --report <single_gpu_throttle>
    --leave-one-out`` with the default device (the card: the CUDA
    ``bocd_step`` screen in float32): the committed attribution sidecar,
    byte for byte, with the screen launched through the kernel."""
    import os

    from repro_torch.launch import whatif

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(root)
    before = bk.bocd_step.launches
    out = tmp_path / "att.json"
    assert whatif.main(["--report", "results/campaigns/single_gpu_throttle-j1-s0.json",
                        "--leave-one-out", "--quiet", "--out", str(out)]) == 0
    assert bk.bocd_step.launches > before
    with open(os.path.join(root, "results", "campaigns",
                           "single_gpu_throttle-j1-s0.attribution.json"), "rb") as f:
        assert out.read_bytes() == f.read()


def _chip_smoke():
    """``chip_smoke.py`` imported by name (its spawned ranks import it too)."""
    import importlib
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def test_mesh_checks_on_card_at_smoke_size(card):
    """chip_smoke.py's phase 18 at smoke size: 4 ranks on the card over
    gloo; the sharded decode (heads sharded, kernel route) equal to the
    unsharded plain route with flash_decode launched on every rank, the
    sequence-sharded kv=1 cache (plain and kernel), the expert-parallel MoE,
    the adaptive step (its change of each leaf to MESH_STEP_RTOL, which the
    step at counts [1, 1] misses) and remap_mesh, each to PARITY_TOL."""
    cs = _chip_smoke()
    name = torch.cuda.get_device_name(0)
    out = cs.phase_mesh(torch, np, name, size="smoke", dev="cuda", timeout=600)
    layers = get_config("granite-3-8b").smoke().num_layers
    assert out["launches"] == [layers * cs.MESH_SIZES["smoke"]["steps"]] * cs.MESH_WORLD
    r0 = out["ranks"][0]
    assert r0["collectives"]["all_reduce"] == "served"
    assert all(c["launches"] > 0 for c in r0["seq_shard"] if c["kernel"])
    assert r0["adaptive"]["step_err"] <= cs.MESH_STEP_RTOL < r0["adaptive"]["control_err"]
