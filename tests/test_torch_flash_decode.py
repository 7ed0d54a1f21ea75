"""The port's flash decode (``repro_torch.kernels.flash_decode``) against the
JAX package: the Pallas kernel in interpret mode and the materialized
oracle ``ref.decode_attention_ref``, on the same numpy inputs.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held to that version on the card
(``tests/test_torch_card.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref

# The reference's tolerances (tests/test_kernels.py:17): float32 differs
# only in summation order; bfloat16 in where the result is rounded.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def inputs(seed, shapes, dtype):
    """The same values as jax arrays and as CPU tensors (bit for bit)."""
    rng = np.random.default_rng(seed)
    arrays = {n: jnp.asarray(rng.normal(size=s), jnp.float32).astype(dtype)
              for n, s in shapes.items()}
    tensors = params_from_numpy({n: np.asarray(a) for n, a in arrays.items()}, "cpu")
    return arrays, tensors


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def decode_inputs(seed, b, skv, h, kvh, hd, dtype):
    return inputs(seed, {"q": (b, h, hd), "k": (b, skv, kvh, hd),
                         "v": (b, skv, kvh, hd)}, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,skv,h,kvh,hd,blk,valid",
    [
        (2, 256, 4, 4, 64, 128, 256),
        (2, 512, 8, 2, 64, 128, 300),   # GQA, partial fill
        (1, 384, 8, 1, 32, 256, 100),   # MQA, non-pow2 cache
        (3, 128, 4, 2, 64, 512, 1),     # one valid position
    ],
)
def test_flash_decode_matches_pallas_and_oracle(b, skv, h, kvh, hd, blk, valid, dtype):
    j, t = decode_inputs(1, b, skv, h, kvh, hd, getattr(jnp, dtype))
    got = ops.flash_decode(t["q"], t["k"], t["v"], valid)
    assert got.dtype == t["q"].dtype and got.shape == (b, h, hd)
    pallas = jops.flash_decode(j["q"], j["k"], j["v"], jnp.int32(valid),
                               block_k=blk, interpret=True)
    oracle = jref.decode_attention_ref(j["q"], j["k"], j["v"], jnp.int32(valid))
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_per_sequence_lengths(dtype):
    b, skv, h, kvh, hd = 4, 256, 4, 2, 64
    j, t = decode_inputs(4, b, skv, h, kvh, hd, getattr(jnp, dtype))
    lens = np.asarray([1, 17, 128, 256], np.int32)
    got = fd.flash_decode(t["q"], t["k"], t["v"], torch.from_numpy(lens))
    pallas = jops.flash_decode(j["q"], j["k"], j["v"], jnp.asarray(lens),
                               block_k=128, interpret=True)
    oracle = jref.decode_attention_ref(j["q"], j["k"], j["v"], jnp.asarray(lens))
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(oracle), **TOL[dtype])


def test_flash_decode_zero_valid_length_gives_zeros_like_pallas():
    """At valid_len = 0 the Pallas kernel gives zeros (acc / max(l, 1e-30)
    with nothing accumulated), not the oracle's uniform mean; the port
    follows the kernel, for a scalar length and per sequence."""
    b, skv, h, kvh, hd = 4, 128, 4, 2, 64
    j, t = decode_inputs(5, b, skv, h, kvh, hd, jnp.float32)
    got = fd.flash_decode(t["q"], t["k"], t["v"], 0)
    pallas = jops.flash_decode(j["q"], j["k"], j["v"], jnp.int32(0),
                               block_k=64, interpret=True)
    np.testing.assert_array_equal(f32(pallas), 0.0)
    np.testing.assert_array_equal(f32(got), 0.0)

    lens = np.asarray([0, 5, 0, 128], np.int32)
    got = fd.flash_decode(t["q"], t["k"], t["v"], torch.from_numpy(lens))
    pallas = jops.flash_decode(j["q"], j["k"], j["v"], jnp.asarray(lens),
                               block_k=64, interpret=True)
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL["float32"])
    np.testing.assert_array_equal(f32(got)[[0, 2]], 0.0)
    assert np.abs(f32(got)[[1, 3]]).max() > 0.0


@pytest.mark.parametrize("valid", [0, 7, [0, 3, 64, 9]])
def test_decode_oracle_twin_matches_jax_oracle(valid):
    """``repro_torch.kernels.ref.decode_attention_ref`` is the twin of the
    JAX oracle, uniform mean at valid_len = 0 included."""
    b, skv, h, kvh, hd = 4, 64, 8, 2, 32
    j, t = decode_inputs(6, b, skv, h, kvh, hd, jnp.float32)
    lens = np.asarray(valid, np.int32)
    got = ref.decode_attention_ref(t["q"], t["k"], t["v"], torch.from_numpy(lens))
    want = jref.decode_attention_ref(j["q"], j["k"], j["v"], jnp.asarray(lens))
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


def test_flash_decode_reads_a_strided_window_of_the_cache():
    """The wrapper takes a slice of a larger cache (the sliding-window view)
    as it is: same result as on a contiguous copy."""
    b, skv, h, kvh, hd = 2, 96, 4, 2, 64
    _, t = decode_inputs(7, b, skv, h, kvh, hd, jnp.float32)
    k_win, v_win = t["k"][:, 10:74], t["v"][:, 10:74]
    assert not k_win.is_contiguous()
    got = fd.flash_decode(t["q"], k_win, v_win, 50)
    want = fd.flash_decode_reference(t["q"], k_win.contiguous(), v_win.contiguous(), 50)
    np.testing.assert_array_equal(f32(got), f32(want))


def test_cpu_calls_do_not_count_as_launches():
    _, t = decode_inputs(8, 1, 32, 2, 1, 32, jnp.float32)
    before = fd.flash_decode.launches
    fd.flash_decode(t["q"], t["k"], t["v"], 5)
    assert fd.flash_decode.launches == before


@pytest.mark.parametrize("max_len,splits", [
    (0, 1), (1, 1), (128, 1), (129, 2), (1088, 8), (32768, 8), (10**6, 8),
])
def test_split_count_follows_the_valid_prefix(max_len, splits):
    """About one split per 128 valid positions, at most 8: the splits of a
    (sequence, KV head) form one thread-block cluster of the portable size."""
    assert fd.num_splits(max_len) == splits


def test_splits_cover_the_valid_prefix_exactly_once():
    """The kernel's split arithmetic (``split_chunk``, c = ceil(len /
    n_split); split s reads [min(s * c, len), min(s * c + c, len)), as the
    kernel's block does) covers [0, valid_len) once, in order, for every
    length up to 2,048 at the split count of a 32,768-position cache (a
    per-sequence ``valid_len``) and at the count its own length gives (an
    int)."""
    skv = 32768
    for length in range(0, 2049):
        for n_split in {fd.num_splits(skv), fd.num_splits(length)}:
            chunk = fd.split_chunk(length, n_split)
            covered = []
            for split in range(n_split):
                start = min(split * chunk, length)
                end = min(start + chunk, length)
                covered.extend(range(start, end))
            assert covered == list(range(length))
