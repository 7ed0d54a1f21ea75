"""The port's mixture of experts (``repro_torch.models.moe``, local
dispatch) against the JAX package's on the same numpy inputs.

``route``: gates, expert indices and the aux loss, in float32 and on
bfloat16 logits, ties included (``jax.lax.top_k`` keeps the lower index
first; so does the port). ``_moe_core`` and ``apply_moe``: the same
routing, the same kept mask (the reference's dispatch lines, applied to
its own indices) and outputs within tolerance, with capacity drops, at a
decode-sized batch (t = B, where capacity 2 drops most choices), with
qwen2-moe's padded experts and its shared experts, and in bfloat16 with a
built tie. Weights are scaled by 1/sqrt(fan-in), so every stage holds
values of order 1. float32: rtol 1e-5, atol 1e-5 (summation order of the
products); bfloat16: the reference's 2e-2 (``tests/test_kernels.py:196``).
The serve and train paths of the MoE architectures are in
``tests/test_torch_{serve,train}.py``.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jconfigs
from repro.models import moe as jmoe
from repro_torch.configs import base as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as tmoe

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def configs(arch, dtype="float32", **overrides):
    """(cfg_j, cfg_t): the arch's smoke config with the same overrides."""
    return tuple(replace(mod.get_config(arch).smoke(), dtype=dtype, **overrides)
                 for mod in (jconfigs, tconfigs))


def moe_params(cfg_j, seed, dtype, tie=None):
    """Random MoE parameters (numpy, the reference's schema) in ``dtype``,
    each matrix scaled by 1/sqrt(its fan-in); ``tie=(a, b)`` makes router
    columns a and b equal, so experts a and b get equal logits for every
    token in both frameworks."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, pdef in jmoe.moe_schema(cfg_j).items():
        if name == "norm":
            out[name] = (1.0 + 0.1 * rng.normal(size=pdef.shape)).astype(np.float32)
        else:
            fan_in = pdef.shape[-2]
            out[name] = (rng.normal(size=pdef.shape) / np.sqrt(fan_in)).astype(np.float32)
    if tie is not None:
        a, b = tie
        out["router"][:, b] = out["router"][:, a]
    jdt = getattr(jnp, dtype)
    params_j = {k: jnp.asarray(v, jdt) for k, v in out.items()}
    return params_j, params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")


def tokens(seed, shape, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    return xj, params_from_numpy({"x": np.asarray(xj)}, "cpu")["x"]


def jax_keep(idx, cfg):
    """The reference's kept mask (its ``_moe_core`` dispatch lines) of
    routed choices ``idx`` (T, k), in sorted order."""
    t, k = idx.shape
    cap = int(t * k / cfg.num_experts * cfg.capacity_factor) + 1
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=cfg.padded_experts)
    starts = jnp.cumsum(counts) - counts
    slot = jnp.arange(t * k) - starts[sorted_e]
    return np.asarray(order), np.asarray(slot < cap)


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("n_real", [None, 13])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_jax(dtype, n_real):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(96, 16)).astype(np.float32)
    lj = jnp.asarray(logits, getattr(jnp, dtype))
    lt = params_from_numpy({"l": np.asarray(lj)}, "cpu")["l"]
    gj, ij, aj = jmoe.route(lj, 4, n_real=n_real)
    gt, it, at = tmoe.route(lt, 4, n_real=n_real)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert gt.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    if n_real is not None:
        assert int(it.max()) < n_real


def test_route_breaks_ties_to_the_lower_index():
    """Equal bf16 logits: whole rows of one value, pairs and runs of equal
    values straddling the k-th place. The reference's order comes back
    exactly; the gates to the last bits of the two softmaxes."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(64, 64)).astype(np.float32)
    base[0] = 0.5                          # one value everywhere
    base[1, 10:20] = 1.25                  # a run across the top 8
    base[2, ::7] = 2.0                     # equal values far apart
    base[3, [63, 5, 40]] = 3.0             # the highest index listed first
    base[4:] = np.round(base[4:] * 4) / 4  # coarse values: ties in most rows
    lj = jnp.asarray(base, jnp.bfloat16)
    lt = params_from_numpy({"l": np.asarray(lj)}, "cpu")["l"]
    assert (np.diff(np.sort(np.asarray(lj, np.float32), axis=1), axis=1) == 0).any(1).all()
    gj, ij, _ = jmoe.route(lj, 8)
    gt, it, _ = tmoe.route(lt, 8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-7)
    assert it[0].tolist() == list(range(8))
    assert it[3, :3].tolist() == [5, 40, 63]


# ----------------------------------------------------- core and the layer
CASES = {
    # label: (arch, overrides, T, tie)
    "drops": ("olmoe-1b-7b", dict(num_experts=8, top_k=2, capacity_factor=0.5), 64, None),
    "decode t=B": ("olmoe-1b-7b", dict(num_experts=64, top_k=8, moe_d_ff=32), 8, None),
    "padded + shared": ("qwen2-moe-a2.7b", dict(num_experts=6, pad_experts_to=8,
                                                top_k=2, capacity_factor=0.75), 48, None),
    "tie": ("olmoe-1b-7b", dict(num_experts=8, top_k=3), 40, (2, 6)),
    "jamba": ("jamba-1.5-large-398b", {}, 32, None),
}


def _core_both(label, dtype, seed=0):
    arch, overrides, t, tie = CASES[label]
    cfg_j, cfg_t = configs(arch, dtype, **overrides)
    params_j, params_t = moe_params(cfg_j, seed, dtype, tie)
    xj, xt = tokens(seed + 1, (t, cfg_j.d_model), dtype)
    return cfg_j, cfg_t, params_j, params_t, xj, xt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label", sorted(CASES))
def test_moe_core_matches_jax(label, dtype):
    cfg_j, cfg_t, params_j, params_t, xj, xt = _core_both(label, dtype)
    t, k = xj.shape[0], cfg_j.top_k
    logits_j = xj @ params_j["router"]
    gj, ij, _ = jmoe.route(logits_j, k, n_real=cfg_j.num_experts)
    with torch.no_grad():
        logits_t = xt @ params_t["router"]
        gt, it, _ = tmoe.route(logits_t, k, n_real=cfg_t.num_experts)
    np.testing.assert_allclose(f32(logits_t), f32(logits_j), **TOL[dtype])
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))

    order_j, keep_j = jax_keep(ij, cfg_j)
    order_t, _, _, keep_t, cap = tmoe.dispatch(it, cfg_t)
    np.testing.assert_array_equal(order_t.numpy(), order_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    assert cap == int(t * k / cfg_j.num_experts * cfg_j.capacity_factor) + 1
    if label in ("drops", "decode t=B", "padded + shared"):
        assert 0 < int((~keep_t).sum()) < t * k, "the case should drop some choices"
    if label == "decode t=B":
        assert cap == 2 and int(keep_t.sum()) <= 2 * cfg_j.num_experts
    if label == "padded + shared":
        assert int(it.max()) < cfg_j.num_experts < cfg_j.padded_experts
    if label == "tie":
        # Experts 2 and 6 tie in every row: 6 is never chosen over 2.
        rows = [r.tolist() for r in it]
        assert any(2 in r for r in rows) and any(6 in r for r in rows)
        for r in rows:
            assert 6 not in r or (2 in r and r.index(2) < r.index(6)), r

    yj, aj = jmoe._moe_core(params_j, xj, cfg_j, 0, cfg_j.padded_experts)
    with torch.no_grad():
        yt, at = tmoe._moe_core(params_t, xt, cfg_t, 0, cfg_t.padded_experts)
    assert yt.dtype == torch.float32 and yt.shape == (t, cfg_j.d_model)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL[dtype])
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label", ["padded + shared", "drops", "jamba"])
def test_apply_moe_matches_jax(label, dtype):
    """The layer: RMSNorm, the routed experts, the shared experts where the
    config has them; (B, S, D) in the activation type, and the aux loss."""
    arch, overrides, t, tie = CASES[label]
    cfg_j, cfg_t = configs(arch, dtype, **overrides)
    params_j, params_t = moe_params(cfg_j, 3, dtype, tie)
    xj, xt = tokens(4, (2, t // 2, cfg_j.d_model), dtype)
    yj, aj = jmoe.apply_moe(params_j, xj, cfg_j)
    with torch.no_grad():
        yt, at = tmoe.apply_moe(params_t, xt, cfg_t)
    assert yt.dtype == xt.dtype and yt.shape == xt.shape
    np.testing.assert_allclose(f32(yt), f32(yj), **TOL[dtype])
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    if cfg_j.num_shared_experts:
        assert "shared_wo" in params_t


def test_moe_gradient_matches_jax():
    """The train path differentiates through the dispatch: gradients of a
    loss on the layer's output in every parameter and the input, float32."""
    cfg_j, cfg_t, params_j, params_t, xj, xt = _core_both("padded + shared", "float32")
    xj, xt = xj.reshape(2, -1, cfg_j.d_model), xt.reshape(2, -1, cfg_j.d_model)

    def loss_j(p, x):
        y, aux = jmoe.apply_moe(p, x, cfg_j)
        return jnp.sum(jnp.sin(y)) + 0.01 * aux

    gj = jax.grad(loss_j, argnums=(0, 1))(params_j, xj)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params_t.items()}
    x = xt.clone().requires_grad_(True)
    y, aux = tmoe.apply_moe(leaves, x, cfg_t)
    (torch.sum(torch.sin(y)) + 0.01 * aux).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj[1]), rtol=1e-4, atol=1e-5)
    for name, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gj[0][name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_combine_adds_a_tokens_rows_in_expert_order():
    """With every expert the identity map, each token's output is its
    gate-weighted kept rows added in ascending expert order (the
    reference's scatter order), bit for bit; two calls agree bit for bit."""
    cfg_j, cfg_t = configs("olmoe-1b-7b", "float32", num_experts=8, top_k=4,
                           capacity_factor=0.75)
    d, e, f = cfg_t.d_model, cfg_t.padded_experts, cfg_t.moe_d_ff
    _, params = moe_params(cfg_j, 5, "float32")
    xt = tokens(6, (40, d), "float32")[1]
    # silu(x) * up(x) @ wo with up = 1 / silu (via gate) is not exact, so
    # replace the SwiGLU by a product the test can write out: experts whose
    # wo reads the gate branch back (f = d, wi_up = I scaled, wo = I).
    params = dict(params)
    cfg_t = replace(cfg_t, moe_d_ff=d)
    eye = torch.eye(d).expand(e, d, d)
    params["wi_gate"] = eye * 30.0          # silu(30 x) / 30 = x to float32 rounding
    params["wi_up"] = eye / 30.0
    params["wo"] = eye.clone()
    with torch.no_grad():
        a, _ = tmoe._moe_core(params, xt, cfg_t, 0, e)
        b, _ = tmoe._moe_core(params, xt, cfg_t, 0, e)
        gates, idx, _ = tmoe.route(xt @ params["router"], cfg_t.top_k)
        order, _, _, keep, _ = tmoe.dispatch(idx, cfg_t)
        h = torch.nn.functional.silu(xt @ (eye[0] * 30.0)) * (xt @ (eye[0] / 30.0))
    assert torch.equal(a, b)
    kept = torch.zeros(idx.numel(), dtype=torch.bool)
    kept[order] = keep
    kept = kept.reshape(idx.shape)
    want = torch.zeros_like(a)
    for tok in range(xt.shape[0]):
        for j in torch.argsort(idx[tok]).tolist():
            if kept[tok, j]:
                want[tok] = want[tok] + h[tok] * gates[tok, j]
    assert not bool(kept.all())
    assert torch.equal(a, want)
