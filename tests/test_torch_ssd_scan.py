"""The port's SSD scan and Mamba2 layer against the JAX package, on the same
numpy inputs.

* ``ref.ssd_ref`` (the kernel's plain version, the sequential recurrence)
  against the reference's ``ref.ssd_ref`` and its Pallas ``ops.ssd_scan``
  in interpret mode, on the three shapes of ``tests/test_kernels.py``, in
  float32 and bfloat16;
* the chunked ``models.ssm.ssd_scan`` (also from an initial state);
* ``apply_mamba`` with ``use_kernel`` (the kernel's plain version on the
  CPU) against the reference's in interpret mode, and without;
* the mamba2-2.7b smoke forward, prefill and decode, on the reference's
  parameters carried over with ``convert.params_from_numpy``;
* the wrapper raising under autograd.

Tolerances: float32 2e-4 and bfloat16 3e-2 for the scan (the reference's,
``tests/test_kernels.py:98``): the port's float32 sums differ from XLA's
in order only. The model paths: float32 1e-4, bfloat16 2e-2
(``tests/test_torch_serve.py``).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.serve import serve_step as jserve
from repro_torch.configs import base as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import serve_step as tserve

SHAPES = [   # b, s, h, p, g, n, chunk (tests/test_kernels.py:84-90)
    (1, 64, 2, 32, 1, 16, 16),
    (2, 128, 4, 64, 2, 32, 32),
    (1, 96, 2, 16, 1, 8, 32),
]
SCAN_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
MODEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def inputs(shape, dtype, seed=20):
    """(jax arrays, torch tensors) of x, dt, a, B, C: x, B and C in
    ``dtype``, dt and a float32, as the reference's kernel tests make them."""
    b, s, h, p, g, n, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(b, s, h)))) * 0.5).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)) * 0.2)).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    j = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm, jdt),
         jnp.asarray(cm, jdt))
    t = tuple(params_from_numpy({"v": np.asarray(v)}, "cpu")["v"] for v in j)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_ref_matches_jax_ref_and_pallas_kernel(shape, dtype):
    j, t = inputs(shape, dtype)
    y_t, st_t = tref.ssd_ref(*t)
    assert y_t.dtype == t[0].dtype and st_t.dtype == t[0].dtype
    y_r, st_r = jref.ssd_ref(*j)
    y_k, st_k = jops.ssd_scan(*j, chunk=shape[-1], interpret=True)
    for want_y, want_st in ((y_r, st_r), (y_k, st_k)):
        np.testing.assert_allclose(f32(y_t), f32(want_y), **SCAN_TOL[dtype])
        np.testing.assert_allclose(f32(st_t), f32(want_st), **SCAN_TOL[dtype])
    # The wrapper on CPU tensors is the plain version.
    y_w, st_w = tops.ssd_scan(*t, chunk=shape[-1])
    np.testing.assert_array_equal(f32(y_w), f32(y_t))
    np.testing.assert_array_equal(f32(st_w), f32(st_t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_chunked_ssd_matches_jax(shape, dtype):
    j, t = inputs(shape, dtype, seed=30)
    chunk = shape[-1]
    y_j, st_j = jssm.ssd_scan(*j, chunk=chunk)
    y_t, st_t = tssm.ssd_scan(*t, chunk=chunk)
    np.testing.assert_allclose(f32(y_t), f32(y_j), **SCAN_TOL[dtype])
    np.testing.assert_allclose(f32(st_t), f32(st_j), **SCAN_TOL[dtype])
    # From an initial state: the second half of the sequence continues the
    # first half's final state.
    b, s, h, p, g, n, _ = shape
    init = np.random.default_rng(31).normal(size=(b, h, p, n)).astype(np.float32)
    init_j = jnp.asarray(init, getattr(jnp, dtype))
    init_t = params_from_numpy({"v": np.asarray(init_j)}, "cpu")["v"]
    y_j, st_j = jssm.ssd_scan(*j, chunk=chunk, initial_state=init_j)
    y_t, st_t = tssm.ssd_scan(*t, chunk=chunk, initial_state=init_t)
    np.testing.assert_allclose(f32(y_t), f32(y_j), **SCAN_TOL[dtype])
    np.testing.assert_allclose(f32(st_t), f32(st_j), **SCAN_TOL[dtype])


def test_chunked_ssd_continues_from_its_own_final_state():
    """Two halves from an initial state give the whole sequence's scan."""
    (_, t) = inputs(SHAPES[1], "float32", seed=32)
    half = SHAPES[1][1] // 2
    y, st = tssm.ssd_scan(*t, chunk=32)
    first = [v[:, :half] if v.dim() > 1 else v for v in t]
    second = [v[:, half:] if v.dim() > 1 else v for v in t]
    y1, st1 = tssm.ssd_scan(*first, chunk=32)
    y2, st2 = tssm.ssd_scan(*second, chunk=32, initial_state=st1)
    np.testing.assert_allclose(f32(torch.cat([y1, y2], dim=1)), f32(y), **SCAN_TOL["float32"])
    np.testing.assert_allclose(f32(st2), f32(st), **SCAN_TOL["float32"])


def setup(dtype, seed=0):
    cfg_j = jconfigs.get_config("mamba2-2.7b").smoke()
    cfg_t = tconfigs.get_config("mamba2-2.7b").smoke()
    params_j = jmodel.init_params(cfg_j, seed)
    if dtype == "float32":
        cfg_j, cfg_t = replace(cfg_j, dtype=dtype), replace(cfg_t, dtype=dtype)
        params_j = jax.tree.map(lambda a: a.astype(jnp.float32), params_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_matches_jax(dtype, use_kernel):
    """One Mamba2 block; with ``use_kernel`` the reference runs its Pallas
    kernel in interpret mode and the port the kernel's plain version."""
    cfg_j, cfg_t, params_j, params_t = setup(dtype)
    p_j = jax.tree.map(lambda a: a[0], params_j["blocks"]["sub0"]["mamba"])
    p_t = params_from_numpy(jax.tree.map(np.asarray, p_j), "cpu")
    x = np.random.default_rng(4).normal(size=(2, 32, cfg_j.d_model)).astype(np.float32)
    x_j = jnp.asarray(x, cfg_j.activation_dtype)
    x_t = params_from_numpy({"x": np.asarray(x_j)}, "cpu")["x"]
    want = jssm.apply_mamba(p_j, x_j, cfg_j, use_kernel=use_kernel)
    with torch.no_grad():
        got = tssm.apply_mamba(p_t, x_t, cfg_t, use_kernel=use_kernel)
    assert got.dtype == cfg_t.activation_dtype
    np.testing.assert_allclose(f32(got), f32(want), **MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_prefill_and_decode_match_jax(dtype):
    """The mamba2-2.7b smoke model: forward through both SSD routes,
    prefill logits and caches, then 6 decode steps teacher-forced with the
    reference's tokens, and the serve driver's greedy tokens."""
    cfg_j, cfg_t, params_j, params_t = setup(dtype)
    b, s, gen = 2, 32, 6
    tokens = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (b, s))
    batch_j = {"tokens": jnp.asarray(tokens, jnp.int32)}
    batch_t = {"tokens": torch.from_numpy(tokens)}
    tol = MODEL_TOL[dtype]

    for use_kernel in (False, True):
        want, _ = jmodel.forward(params_j, batch_j, cfg_j, use_kernel=use_kernel)
        with torch.no_grad():
            got, aux = tmodel.forward(params_t, batch_t, cfg_t, use_kernel=use_kernel)
        np.testing.assert_allclose(f32(got), f32(want), **tol)
        assert float(aux) == 0.0

    logits_j, caches_j = jax.jit(jserve.make_prefill_step(cfg_j, s))(params_j, batch_j)
    with torch.no_grad():
        logits_t, caches_t = tserve.make_prefill_step(cfg_t, s)(params_t, batch_t)
    np.testing.assert_allclose(f32(logits_t), f32(logits_j), **tol)
    for name in ("state", "conv_x", "conv_bc"):
        assert caches_t["sub0"][name].shape == caches_j["sub0"][name].shape
        np.testing.assert_allclose(f32(caches_t["sub0"][name]),
                                   f32(caches_j["sub0"][name]), **tol)

    caches_j = jtransformer.grow_caches(caches_j, cfg_j, s + gen)
    caches_t = ttransformer.grow_caches(caches_t, cfg_t, s + gen)
    decode_j = jax.jit(jserve.make_decode_step(cfg_j, s + gen))
    decode_t = tserve.make_decode_step(cfg_t, s + gen)
    tok = jnp.argmax(logits_j[:, -1], axis=-1).reshape(b, 1).astype(jnp.int32)
    greedy = []
    for step in range(gen):
        want, caches_j = decode_j(params_j, tok, caches_j, jnp.asarray(s + step, jnp.int32))
        with torch.no_grad():
            got, caches_t = decode_t(params_t, torch.from_numpy(np.array(tok)),
                                     caches_t, s + step)
        np.testing.assert_allclose(f32(got), f32(want), **tol)
        np.testing.assert_allclose(f32(caches_t["sub0"]["state"]),
                                   f32(caches_j["sub0"]["state"]), **tol)
        tok = jnp.argmax(want[:, -1], axis=-1).reshape(b, 1).astype(jnp.int32)
        greedy.append(np.asarray(tok)[:, 0])

    res = tlaunch.serve(cfg_t, params_t, tokens, gen=gen, device="cpu")
    assert res.tokens.shape == (b, gen)
    if dtype == "float32":
        np.testing.assert_array_equal(res.tokens[:, :gen - 1], np.stack(greedy, 1)[:, :gen - 1])


def test_decode_continues_the_kernel_forward():
    """In float32, decode logits after a prefill equal the forward's logits
    at the same positions of the same sequence (kernel route on the CPU):
    the chunked scan and the recurrence agree through the stack."""
    _, cfg, _, params = setup("float32")
    b, s, gen = 2, 32, 16   # s + gen a multiple of the chunk (16)
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s + gen)))
    with torch.no_grad():
        full, _ = tmodel.forward(params, {"tokens": tokens}, cfg, use_kernel=True)
        logits, caches = tserve.make_prefill_step(cfg, s)(params, {"tokens": tokens[:, :s]})
        np.testing.assert_allclose(f32(logits[:, 0]), f32(full[:, s - 1]),
                                   **MODEL_TOL["float32"])
        caches = ttransformer.grow_caches(caches, cfg, s + gen)
        decode = tserve.make_decode_step(cfg, s + gen)
        for step in range(gen):
            got, caches = decode(params, tokens[:, s + step : s + step + 1], caches, s + step)
            np.testing.assert_allclose(f32(got[:, 0]), f32(full[:, s + step]),
                                       **MODEL_TOL["float32"])


def test_ssd_scan_raises_under_autograd_on_the_cpu():
    _, t = inputs(SHAPES[0], "float32")
    x = t[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tssd.ssd_scan(x, *t[1:], chunk=16)
    with pytest.raises(RuntimeError, match="no gradient"):
        tops.ssd_scan(t[0], t[1].clone().requires_grad_(True), *t[2:], chunk=16)
    with torch.no_grad():
        y, _ = tssd.ssd_scan(x, *t[1:], chunk=16)
    assert not y.requires_grad
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan(*t, chunk=24)
    assert tssd.ssd_scan.launches == 0   # CPU calls launch nothing


def test_model_kernel_route_raises_under_autograd():
    """``use_kernel`` cannot be trained through, as in the reference."""
    _, cfg, _, params = setup("float32")
    w = params["blocks"]["sub0"]["mamba"]["w_x"].requires_grad_(True)
    tokens = torch.zeros((1, 16), dtype=torch.int64)
    batch = {"tokens": tokens, "labels": tokens}
    with pytest.raises(RuntimeError, match="no gradient"):
        tmodel.loss_fn(params, batch, cfg, use_kernel=True)
    loss, _ = tmodel.loss_fn(params, batch, cfg)
    loss.backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())


def test_chunked_ssd_gradient_is_finite_at_a_full_chunk():
    """At a 128-step chunk the decay exponent above the diagonal overflows
    (here dt * |a| sums to ~128). The reference's where(tri, exp(rel), 0)
    then has a NaN gradient; the port masks before the exp: the same
    values, and the gradient of the sequential recurrence (float32, 2e-4)."""
    b, s, h, p, g, n, chunk = 1, 128, 2, 16, 1, 8, 128
    rng = np.random.default_rng(40)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.ones((b, s, h), np.float32)
    a = -np.ones((h,), np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    j = [jnp.asarray(v) for v in (x, dt, a, bm, cm)]
    want_y, _ = jssm.ssd_scan(*j, chunk=chunk)
    jgrad = jax.grad(lambda d: jnp.sum(jssm.ssd_scan(j[0], d, *j[2:], chunk=chunk)[0]))(j[1])
    assert np.isnan(np.asarray(jgrad)).any()   # the reference's gradient in dt

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_(True)
        dtt = torch.from_numpy(dt).requires_grad_(True)
        y = fn(xt, dtt, *(torch.from_numpy(v) for v in (a, bm, cm)))[0]
        return y, torch.autograd.grad(y.sum(), (xt, dtt))

    y, got = grads(lambda *t: tssm.ssd_scan(*t, chunk=chunk))
    np.testing.assert_allclose(f32(y), np.asarray(want_y), **SCAN_TOL["float32"])
    _, want = grads(tref.ssd_ref)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(f32(g), f32(w), **SCAN_TOL["float32"])


def test_ssm_caches_match_the_reference_layout():
    cfg_j = jconfigs.get_config("mamba2-2.7b").smoke()
    cfg_t = tconfigs.get_config("mamba2-2.7b").smoke()
    want = jssm.init_ssm_cache(cfg_j, 3)
    got = tssm.init_ssm_cache(cfg_t, 3, "cpu")
    shapes = tssm.ssm_cache_shape(cfg_t, 3)
    assert sorted(got) == sorted(want) == sorted(shapes)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape == shapes[name][0]
        assert got[name].dtype == shapes[name][1] == torch.bfloat16
        assert not bool(got[name].any())
    stacked = ttransformer.init_caches(cfg_t, 3, 8, device="cpu")
    jstacked = jtransformer.init_caches(cfg_j, 3, 8)
    for name in want:
        assert tuple(stacked["sub0"][name].shape) == jstacked["sub0"][name].shape


def test_mamba2_param_count_matches_reference():
    cfg_j = jconfigs.get_config("mamba2-2.7b")
    cfg_t = tconfigs.get_config("mamba2-2.7b")
    from repro.models.schema import count_params as jcount
    from repro_torch.models.schema import count_params as tcount

    n = tcount(tmodel.model_schema(cfg_t))
    assert n == jcount(jmodel.model_schema(cfg_j))
    assert 2.80e9 < n < 2.85e9
