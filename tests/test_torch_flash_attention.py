"""The port's flash attention (``repro_torch.kernels.flash_attention``) and
blocked attention against the JAX package: the Pallas kernel in interpret
mode, the materialized oracle ``ref.attention_ref`` and the pure-jnp
``blocked_attention``, on the same numpy inputs.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held to that version on the card
(``tests/test_torch_card.py``, ``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention

# The reference's tolerances (tests/test_kernels.py:17).
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def qkv(seed, b, sq, skv, h, kvh, hd, dtype):
    """The same values as jax arrays and as CPU tensors (bit for bit)."""
    rng = np.random.default_rng(seed)
    shapes = {"q": (b, sq, h, hd), "k": (b, skv, kvh, hd), "v": (b, skv, kvh, hd)}
    j = {n: jnp.asarray(rng.normal(size=s), jnp.float32).astype(dtype)
         for n, s in shapes.items()}
    t = params_from_numpy({n: np.asarray(a) for n, a in j.items()}, "cpu")
    return j, t


def f32(x):
    return np.asarray(x.float() if hasattr(x, "float") else x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,sq,skv,h,kvh,hd,blk",
    [
        (1, 128, 128, 4, 4, 64, 64),
        (2, 256, 256, 4, 2, 64, 128),
        (1, 64, 64, 8, 1, 32, 32),  # MQA, tiny blocks
        (1, 192, 192, 2, 2, 64, 64),  # non-power-of-two seq
    ],
)
def test_flash_attention_matches_pallas_and_oracle(b, sq, skv, h, kvh, hd, blk, dtype):
    j, t = qkv(0, b, sq, skv, h, kvh, hd, getattr(jnp, dtype))
    got = ops.flash_attention(t["q"], t["k"], t["v"], causal=True)
    assert got.dtype == t["q"].dtype and got.shape == (b, sq, h, hd)
    pallas = jops.flash_attention(j["q"], j["k"], j["v"], causal=True,
                                  block_q=blk, block_k=blk, interpret=True)
    oracle = jref.attention_ref(j["q"], j["k"], j["v"], causal=True)
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("window", [16, 64])
def test_flash_attention_sliding_window(window):
    j, t = qkv(3, 1, 128, 128, 4, 2, 64, jnp.float32)
    got = fa.flash_attention(t["q"], t["k"], t["v"], causal=True, window=window)
    pallas = jops.flash_attention(j["q"], j["k"], j["v"], causal=True, window=window,
                                  block_q=32, block_k=32, interpret=True)
    oracle = jref.attention_ref(j["q"], j["k"], j["v"], causal=True, window=window)
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL["float32"])
    np.testing.assert_allclose(f32(got), f32(oracle), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_noncausal(dtype):
    j, t = qkv(6, 1, 128, 128, 2, 2, 64, getattr(jnp, dtype))
    got = fa.flash_attention(t["q"], t["k"], t["v"], causal=False)
    pallas = jops.flash_attention(j["q"], j["k"], j["v"], causal=False,
                                  block_q=64, block_k=64, interpret=True)
    oracle = jref.attention_ref(j["q"], j["k"], j["v"], causal=False)
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_attention_oracle_twin_matches_jax_oracle(causal, window):
    j, t = qkv(9, 2, 40, 40, 4, 2, 32, jnp.float32)
    got = ref.attention_ref(t["q"], t["k"], t["v"], causal=causal, window=window)
    want = jref.attention_ref(j["q"], j["k"], j["v"], causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,q_offset,kv_block", [
    (True, 0, 0, 1024),     # one block: the serve prefill's case
    (True, 0, 0, 48),       # several blocks, a ragged last one
    (True, 40, 0, 32),      # sliding window across blocks
    (False, 0, 0, 64),
    (True, 0, 16, 32),      # continuation: q starts at position 16
])
def test_blocked_attention_matches_jax(dtype, causal, window, q_offset, kv_block):
    j, t = qkv(11, 2, 100, 100 + q_offset, 4, 2, 64, getattr(jnp, dtype))
    if q_offset:
        j["q"], t["q"] = j["q"][:, :84], t["q"][:, :84]
    got = attention.blocked_attention(t["q"], t["k"], t["v"], causal=causal,
                                      window=window, q_offset=q_offset,
                                      kv_block=kv_block)
    want = jattn.blocked_attention(j["q"], j["k"], j["v"], causal=causal,
                                   window=window, q_offset=q_offset,
                                   kv_block=kv_block)
    assert got.dtype == t["q"].dtype
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def test_cpu_calls_do_not_count_as_launches():
    _, t = qkv(12, 1, 16, 16, 2, 1, 32, jnp.float32)
    before = fa.flash_attention.launches
    fa.flash_attention(t["q"], t["k"], t["v"])
    assert fa.flash_attention.launches == before


def emulate_bf16_kernel(q, k, v, *, causal, window, block_q=128, block_k=128):
    """The bf16 CUDA kernel's rounding points in plain torch: float32 scores
    of bf16 operands (their products are exact), the scale times log2(e) on
    the float32 score, an online softmax over 128-key tiles from each
    128-row block's first visible key, P rounded to bf16 before P V, float32
    accumulation, the output rounded once to bf16."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    sl2 = torch.tensor(hd**-0.5, dtype=torch.float32) * math.log2(math.e)
    out = torch.zeros((b, sq, h, hd), dtype=torch.bfloat16)
    for q0 in range(0, sq, block_q):
        rows = torch.arange(q0, min(q0 + block_q, sq))
        k_end = min(skv, int(rows[-1]) + 1) if causal else skv
        k_begin = max(0, q0 - window + 1) if window else 0
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros((b, h, len(rows)))
        acc = torch.zeros((b, h, len(rows), hd))
        for k0 in range(k_begin, k_end, block_k):
            cols = torch.arange(k0, min(k0 + block_k, skv))
            s = torch.einsum("brhd,bchd->bhrc", qf[:, rows], kf[:, cols]) * sl2
            mask = torch.ones((len(rows), len(cols)), dtype=torch.bool)
            if causal:
                mask &= rows[:, None] >= cols[None, :]
            if window:
                mask &= rows[:, None] - cols[None, :] < window
            s = torch.where(mask, s, torch.tensor(-1e30))
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mn)
            p = torch.exp2(s - mn[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhrc,bchd->bhrd", p.to(torch.bfloat16).float(), vf[:, cols])
            m = mn
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, rows] = o.permute(0, 2, 1, 3).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window", [
    (1, 256, 256, 4, 2, 64, True, 0),      # causal GQA
    (1, 128, 128, 2, 2, 64, False, 0),     # non-causal
    (1, 200, 200, 4, 2, 128, True, 48),    # window 48
    (2, 130, 130, 4, 4, 128, True, 0),     # ragged Sq 130
    (1, 96, 160, 8, 1, 64, False, 0),      # MQA, Sq 96 != Skv 160
])
def test_bf16_kernel_rounding_fits_the_reference_tolerance(b, sq, skv, h, kvh, hd, causal,
                                                           window):
    """The bf16 kernel rounds P to bf16 before P V (2^-9 relative per
    element); emulated in plain torch, that stays within the reference's
    bf16 tolerance of the Pallas kernel (interpret mode) and of the oracle,
    on the small cases ``chip_smoke.py`` holds the kernel to."""
    j, t = qkv(13, b, sq, skv, h, kvh, hd, jnp.bfloat16)
    got = emulate_bf16_kernel(t["q"], t["k"], t["v"], causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, h, hd)
    pallas = jops.flash_attention(j["q"], j["k"], j["v"], causal=causal, window=window,
                                  block_q=64, block_k=64, interpret=True)
    oracle = jref.attention_ref(j["q"], j["k"], j["v"], causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL["bfloat16"])
    np.testing.assert_allclose(f32(got), f32(oracle), **TOL["bfloat16"])
