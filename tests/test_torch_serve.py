"""The port's serving path (``repro_torch.models``, ``repro_torch.serve``,
``repro_torch.launch.serve``) against the JAX package on the same weights:
the reference's parameters, made by ``repro.models.model.init_params``,
are carried over with ``repro_torch.convert.params_from_numpy``.

For the seven dense-attention architectures and the three mixture-of-experts
ones (olmoe-1b-7b, qwen2-moe-a2.7b, jamba-1.5-large, whose Mamba2 layers
ride along) at ``.smoke()`` size: prefill logits and caches, one decode
step's logits, ``forward`` logits and aux loss, and 8 greedy tokens through
``launch.serve.serve``; the prefill also with ``use_kernel`` (the port's
flash attention, its plain version on the CPU). In float32 (config and
parameters upcast exactly) the two agree to 1e-4 and the tokens are
identical; in bfloat16 to the reference's 2e-2 (``tests/test_kernels.py:196``).
"""
import re
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jconfigs
from repro.launch import serve as jlaunch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.models.schema import count_params as jcount
from repro.serve import serve_step as jserve
from repro_torch.configs import base as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.models.schema import count_params as tcount
from repro_torch.serve import serve_step as tserve

ARCHS = ["falcon-demo-100m", "granite-3-8b", "granite-20b", "yi-9b",
         "mistral-nemo-12b", "qwen2-vl-72b", "musicgen-large",
         "olmoe-1b-7b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b"]
B, S, GEN = 2, 16, 8
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
#: jamba's smoke model is 16 layers deep (a period of 8, twice): in
#: bfloat16 both packages part from the float32 run by more than the
#: per-layer 2e-2 (measured: JAX 0.030, the port 0.034 in logits), so its
#: bfloat16 run is held by DEPTH_RATIO instead
#: (test_deep_hybrid_bf16_tracks_float32_as_jax_does)
DEEP = "jamba-1.5-large-398b"
SERVE_CASES = [(arch, dtype) for arch in ARCHS for dtype in ("float32", "bfloat16")
               if (arch, dtype) != (DEEP, "bfloat16")]
#: each case on the plain route (under its old id) and the kernel route
SERVE_ROUTES = ([pytest.param(a, d, False, id=f"{a}-{d}") for a, d in SERVE_CASES]
                + [pytest.param(a, d, True, id=f"{a}-{d}-kernel") for a, d in SERVE_CASES])


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def setup(arch, dtype, seed=0):
    """(cfg_j, cfg_t, params_j, params_t, batch_j, batch_t) on one set of
    weights and inputs."""
    cfg_j = jconfigs.get_config(arch).smoke()
    cfg_t = tconfigs.get_config(arch).smoke()
    params_j = jmodel.init_params(cfg_j, seed)
    if dtype == "float32":
        cfg_j, cfg_t = replace(cfg_j, dtype=dtype), replace(cfg_t, dtype=dtype)
        params_j = jax.tree.map(lambda a: a.astype(jnp.float32), params_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    rng = np.random.default_rng(seed + 1)
    if cfg_j.modality == "vision_embeds":
        pos = np.arange(S)
        batch = {"embeds": rng.normal(size=(B, S, cfg_j.d_model)).astype(np.float32),
                 "positions": np.broadcast_to(
                     np.stack([pos, pos // 2, pos % 5])[:, None], (3, B, S)).copy()}
    elif cfg_j.modality == "audio_codes":
        batch = {"tokens": rng.integers(0, cfg_j.vocab_size, (B, S, cfg_j.num_codebooks))}
    else:
        batch = {"tokens": rng.integers(0, cfg_j.vocab_size, (B, S))}
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    if "embeds" in batch_j:
        batch_j["embeds"] = batch_j["embeds"].astype(cfg_j.activation_dtype)
    batch_t = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()
               if k != "embeds"}
    if "embeds" in batch_j:
        batch_t["embeds"] = params_from_numpy({"e": np.asarray(batch_j["embeds"])}, "cpu")["e"]
    return cfg_j, cfg_t, params_j, params_t, batch_j, batch_t


def jax_next_input(params, logits, cfg):
    """The driver's greedy next input, in jax (``_next_input``'s twin)."""
    nxt = jnp.argmax(logits[:, -1], axis=-1)
    if cfg.modality == "audio_codes":
        return nxt.reshape(B, 1, cfg.num_codebooks).astype(jnp.int32), nxt[..., 0]
    tok = nxt.reshape(B, 1).astype(jnp.int32)
    if cfg.modality == "vision_embeds":
        return jlayers.apply_embed(params["embed"], tok, cfg), nxt
    return tok, nxt


def jax_serve(cfg, params, batch, gen):
    """The reference's prefill + greedy decode loop (``repro.launch.serve``
    with the audio/vision token handling of the port's driver)."""
    prefill = jax.jit(jserve.make_prefill_step(cfg, S))
    logits0, caches = prefill(params, batch)
    caches = jtransformer.grow_caches(caches, cfg, S + gen)
    decode = jax.jit(jserve.make_decode_step(cfg, S + gen))
    tok, _ = jax_next_input(params, logits0, cfg)
    inputs, step_logits, out = [], [], []
    for step in range(gen):
        inputs.append(np.asarray(tok))
        logits, caches = decode(params, tok, caches, jnp.asarray(S + step, jnp.int32))
        step_logits.append(logits)
        tok, rec = jax_next_input(params, logits, cfg)
        out.append(np.asarray(rec))
    return logits0, inputs, step_logits, np.stack(out, axis=1)


@pytest.mark.parametrize("arch,dtype,use_kernel", SERVE_ROUTES)
def test_serve_path_matches_jax(arch, dtype, use_kernel):
    """The reference runs its plain route throughout; the port's prefill
    runs the route ``use_kernel`` picks. The forward, the serve driver and
    the decode steps are held on the plain route only (the driver's kernel
    route: test_serve_prefill_calls_flash_attention_once_per_attention_layer)."""
    cfg_j, cfg_t, params_j, params_t, batch_j, batch_t = setup(arch, dtype)
    tol = TOL[dtype]

    # Prefill: last-token logits and the period-stacked caches.
    logits_j, caches_j = jax.jit(jserve.make_prefill_step(cfg_j, S))(params_j, batch_j)
    with torch.no_grad():
        logits_t, caches_t = tserve.make_prefill_step(cfg_t, S, use_kernel=use_kernel)(
            params_t, batch_t)
    assert logits_t.dtype == cfg_t.activation_dtype
    np.testing.assert_allclose(f32(logits_t), f32(logits_j), **tol)
    assert sorted(caches_t) == sorted(caches_j)
    for key, leaves in caches_j.items():
        assert sorted(caches_t[key]) == sorted(leaves)
        for name, want in leaves.items():
            np.testing.assert_allclose(f32(caches_t[key][name]), f32(want), **tol,
                                       err_msg=f"{key}/{name}")
    if use_kernel:
        return

    # Forward over the prompt.
    fwd_j, aux_j = jax.jit(lambda p, b: jmodel.forward(p, b, cfg_j))(params_j, batch_j)
    with torch.no_grad():
        fwd_t, aux = tmodel.forward(params_t, batch_t, cfg_t)
    np.testing.assert_allclose(f32(fwd_t), f32(fwd_j), **tol)
    aux_tol = tol if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(aux), float(aux_j), **aux_tol)
    assert (float(aux) > 0.0) == (cfg_t.family in ("moe", "hybrid"))

    # The serve driver: 8 greedy tokens.
    res = tlaunch.serve(cfg_t, params_t, batch_t, gen=GEN, device="cpu")
    first_j, inputs_j, steps_j, tokens_j = jax_serve(cfg_j, params_j, batch_j, GEN)
    np.testing.assert_allclose(f32(res.prefill_logits), f32(first_j), **tol)
    if dtype == "float32":
        np.testing.assert_array_equal(res.tokens, tokens_j)
        np.testing.assert_allclose(f32(res.logits), f32(steps_j[-1]), **tol)
    else:
        # In bf16 greedy paths may part at a near tie (bf16 logits of
        # magnitude ~1 are spaced 2^-7 apart), so the decode steps are held
        # to the reference teacher-forced: the reference's own inputs, step
        # by step, on the port's prefilled caches.
        caches = ttransformer.grow_caches(caches_t, cfg_t, S + GEN)
        decode = tserve.make_decode_step(cfg_t, S + GEN)
        for step, (tok, want) in enumerate(zip(inputs_j, steps_j)):
            tok_t = params_from_numpy({"t": tok}, "cpu")["t"]
            with torch.no_grad():
                got, caches = decode(params_t, tok_t, caches, S + step)
            np.testing.assert_allclose(f32(got), f32(want), **tol)
    assert res.tokens.shape == (B, GEN)
    assert np.isfinite(f32(res.logits)).all()


#: the port's bfloat16 logits part from the float32 run by at most this
#: times the reference's (a routing flip or a wrong layer reads many times)
DEPTH_RATIO = 2.0


def test_deep_hybrid_bf16_tracks_float32_as_jax_does():
    """jamba (Mamba2 + attention + MoE, 16 layers) in bfloat16: prefill,
    forward and one decode step's logits part from the reference's float32
    run (the same weights, upcast) by at most DEPTH_RATIO times as much as
    the reference's own bfloat16 run does; the routing and everything else
    of this model is held in float32 by ``test_serve_path_matches_jax``."""
    cfg_j, cfg_t, params_j, params_t, batch_j, batch_t = setup(DEEP, "bfloat16")
    cfg32 = replace(cfg_j, dtype="float32")
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params_j)
    tok = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (B, 1))

    def jax_run(cfg, params):
        logits, caches = jax.jit(jserve.make_prefill_step(cfg, S))(params, batch_j)
        fwd, _ = jax.jit(lambda p, b: jmodel.forward(p, b, cfg))(params, batch_j)
        caches = jtransformer.grow_caches(caches, cfg, S + 1)
        step, _ = jax.jit(jserve.make_decode_step(cfg, S + 1))(
            params, jnp.asarray(tok, jnp.int32), caches, jnp.asarray(S, jnp.int32))
        return [f32(a) for a in (logits, fwd, step)]

    want = jax_run(cfg32, params32)
    ref = jax_run(cfg_j, params_j)
    with torch.no_grad():
        logits, caches = tserve.make_prefill_step(cfg_t, S)(params_t, batch_t)
        fwd, _ = tmodel.forward(params_t, batch_t, cfg_t)
        caches = ttransformer.grow_caches(caches, cfg_t, S + 1)
        step, _ = tserve.make_decode_step(cfg_t, S + 1)(
            params_t, torch.from_numpy(tok), caches, S)
    for name, got, r, w in zip(("prefill", "forward", "decode"),
                               (logits, fwd, step), ref, want):
        got = f32(got)
        assert np.isfinite(got).all(), name
        port_err, ref_err = np.abs(got - w).max(), np.abs(r - w).max()
        assert 0 < ref_err and port_err <= DEPTH_RATIO * ref_err, (name, port_err, ref_err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax_on_one_cache(dtype):
    """One decode step from the same prefilled cache: logits and the cache
    row written at pos, through the plain path and the kernel path (the
    Pallas kernel in interpret mode; the kernel's plain version here)."""
    cfg_j, cfg_t, params_j, params_t, batch_j, batch_t = setup("mistral-nemo-12b", dtype)
    _, caches_j = jax.jit(jserve.make_prefill_step(cfg_j, S))(params_j, batch_j)
    caches_j = jtransformer.grow_caches(caches_j, cfg_j, S + 4)
    caches_t = params_from_numpy(jax.tree.map(np.asarray, caches_j), "cpu")
    tok = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (B, 1))
    for use_kernel in (False, True):
        want, new_j = jmodel.decode_step(params_j, jnp.asarray(tok, jnp.int32), caches_j,
                                         jnp.asarray(S, jnp.int32), cfg_j,
                                         use_kernel=use_kernel)
        c_t = jax.tree.map(torch.clone, caches_t)
        with torch.no_grad():
            got, new_t = tmodel.decode_step(params_t, torch.from_numpy(tok), c_t, S, cfg_t,
                                            use_kernel=use_kernel)
        assert new_t is c_t   # updated in place
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
        np.testing.assert_allclose(f32(new_t["sub0"]["k"][:, :, S]),
                                   f32(new_j["sub0"]["k"][:, :, S]), **TOL[dtype])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_attention_sliding_window_matches_jax(use_kernel):
    """``decode_attention`` with window > 0 (the long-context decode): only
    the trailing ``window`` cache entries are read."""
    cfg_j, cfg_t, params_j, params_t, _, _ = setup("granite-3-8b", "float32")
    p_j = jax.tree.map(lambda a: a[0], params_j["blocks"]["sub0"]["attn"])
    p_t = params_from_numpy(jax.tree.map(np.asarray, p_j), "cpu")
    rng = np.random.default_rng(5)
    s_max, window, pos = 48, 12, 30
    x = rng.normal(size=(B, 1, cfg_j.d_model)).astype(np.float32)
    hd, kv = cfg_j.resolved_head_dim, cfg_j.num_kv_heads
    cache = {n: rng.normal(size=(B, s_max, kv, hd)).astype(np.float32) for n in "kv"}
    want, new_j = jattn.decode_attention(
        p_j, jnp.asarray(x), {n: jnp.asarray(a) for n, a in cache.items()},
        jnp.asarray(pos, jnp.int32), cfg_j, window=window, use_kernel=use_kernel)
    cache_t = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    with torch.no_grad():
        got, new_t = tattn.decode_attention(p_t, torch.from_numpy(x), cache_t, pos,
                                            cfg_t, window=window, use_kernel=use_kernel)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])
    np.testing.assert_allclose(f32(new_t["k"]), f32(new_j["k"]), **TOL["float32"])
    # The window matters: attending the whole prefix gives another result.
    with torch.no_grad():
        full, _ = tattn.decode_attention(p_t, torch.from_numpy(x), cache_t, pos, cfg_t)
    assert np.abs(f32(full) - f32(got)).max() > 1e-3


def test_forward_kernel_path_matches_jax_kernel_path():
    """``forward(use_kernel=True)``: the Pallas flash attention in interpret
    mode against the port's kernel path (its plain version on the CPU)."""
    cfg_j, cfg_t, params_j, params_t, batch_j, batch_t = setup("granite-3-8b", "float32")
    want, _ = jmodel.forward(params_j, batch_j, cfg_j, use_kernel=True)
    with torch.no_grad():
        got, _ = tmodel.forward(params_t, batch_t, cfg_t, use_kernel=True)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ["granite-3-8b", DEEP])
def test_serve_prefill_calls_flash_attention_once_per_attention_layer(
        arch, use_kernel, monkeypatch):
    """``serve(use_kernel=True)`` takes the prefill's attention through
    ``kernel_ops.flash_attention``, once per attention layer over the whole
    prompt (jamba's Mamba2 layers take none); the decode never calls it, and
    ``use_kernel=False`` never does."""
    cfg = tconfigs.get_config(arch).smoke()
    params = tmodel.init_params(cfg, 0, device="cpu")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    real, shapes = tattn.kernel_ops.flash_attention, []

    def counted(q, k, v, **kw):
        shapes.append(tuple(q.shape[:2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn.kernel_ops, "flash_attention", counted)
    res = tlaunch.serve(cfg, params, prompt, gen=3, use_kernel=use_kernel, device="cpu")
    attn_layers = cfg.n_periods * sum(sub.mixer == "attn" for sub in cfg.period)
    assert 0 < attn_layers <= cfg.num_layers
    assert (attn_layers < cfg.num_layers) == (arch == DEEP)
    assert shapes == ([(B, S)] * attn_layers if use_kernel else [])
    assert res.tokens.shape == (B, 3)


def test_kernel_prefill_refuses_an_ambient_mesh():
    """The sharded prefill has no kernel route, so under a mesh
    ``use_kernel=True`` raises rather than run the plain attention."""
    from repro_torch.sharding import set_mesh

    cfg = tconfigs.get_config("granite-3-8b").smoke()
    prefill = tserve.make_prefill_step(cfg, S, use_kernel=True)
    with set_mesh(object()), pytest.raises(ValueError, match="no kernel route"):
        prefill({}, {"tokens": torch.zeros((B, S), dtype=torch.long)})


#: a dense RoPE model, a hybrid with attention (Mamba2, MoE, no positional
#: encoding) and an M-RoPE vision-embeds model
DEVICE_POS_ARCHS = ["granite-3-8b", DEEP, "qwen2-vl-72b"]


def _step_input(batch, cfg, params, tok):
    """A decode step's input: the token, or its embedding for a
    vision-embeds model (as ``launch.serve._next_input`` gives it)."""
    if cfg.modality == "vision_embeds":
        return tlayers.apply_embed(params["embed"], tok, cfg)
    return tok


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", DEVICE_POS_ARCHS)
def test_decode_at_a_device_position_equals_the_host_position(arch, use_kernel):
    """Two decode steps with ``pos`` a 0-d int32 tensor (the position a CUDA
    graph's replays read) give the logits and every cache leaf of the same
    steps at the host int, bit for bit, on the plain and the kernel route
    (``flash_decode``'s plain version on the CPU); and the eager call of a
    ``DecodeGraph``, the warm-up before its capture, gives the same."""
    _, cfg, _, params, _, batch = setup(arch, "bfloat16")
    with torch.no_grad():
        _, caches = tserve.make_prefill_step(cfg, S)(params, batch)
        caches = ttransformer.grow_caches(caches, cfg, S + 2)
        host = {k: {n: t.clone() for n, t in c.items()} for k, c in caches.items()}
        dev = {k: {n: t.clone() for n, t in c.items()} for k, c in caches.items()}
        warm = {k: {n: t.clone() for n, t in c.items()} for k, c in caches.items()}
        tokens = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab_size, (B, 2)))
        decode = tserve.make_decode_step(cfg, S + 2, use_kernel=use_kernel)
        graph = tserve.DecodeGraph(decode, params, warm,
                                   _step_input(batch, cfg, params, tokens[:, :1]))
        for i in range(2):
            x = _step_input(batch, cfg, params, tokens[:, i:i + 1])
            want, _ = decode(params, x, host, S + i)
            got, _ = decode(params, x, dev, torch.tensor(S + i, dtype=torch.int32))
            warmed = graph(x, S + i)
            for logits in (got, warmed):
                assert logits.dtype == want.dtype and torch.equal(logits, want)
            for key in host:
                for name in host[key]:
                    assert torch.equal(dev[key][name], host[key][name]), (i, key, name)
                    assert torch.equal(warm[key][name], host[key][name]), (i, key, name)
    assert graph.replays == 0 and graph.graph is None


@pytest.mark.parametrize("arch", ["granite-3-8b", DEEP])
def test_serve_on_the_cpu_replays_no_graph_and_serves_the_eager_tokens(arch):
    """Without a card no decode step is captured: ``graph_steps`` and the
    ``serve.graph_replays`` counter read 0, and ``serve`` gives the tokens
    and last logits of the greedy loop over decode steps at host
    positions."""
    from repro_torch.obs import runtime

    cfg = tconfigs.get_config(arch).smoke()
    params = tmodel.init_params(cfg, 0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)))
    runtime.reset()
    try:
        with runtime.recording():
            res = tlaunch.serve(cfg, params, prompt, gen=GEN, use_kernel=True, device="cpu")
        assert runtime.counts()["serve.graph_replays"] == {"ticks": 1, "sum": 0, "max": 0}
    finally:
        runtime.reset()
    assert res.graph_steps == 0
    with torch.no_grad():
        logits, caches = tserve.make_prefill_step(cfg, S, use_kernel=True)(
            params, {"tokens": prompt})
        caches = ttransformer.grow_caches(caches, cfg, S + GEN)
        decode = tserve.make_decode_step(cfg, S + GEN, use_kernel=True)
        want = []
        for step in range(GEN):
            tok = torch.argmax(logits[:, -1], dim=-1).reshape(B, 1)
            logits, caches = decode(params, tok, caches, S + step)
            want.append(torch.argmax(logits[:, -1], dim=-1).numpy())
    np.testing.assert_array_equal(res.tokens, np.stack(want, axis=1))
    assert torch.equal(res.logits, logits)


def test_the_decode_graph_engages_on_a_card_without_mesh_or_window():
    """``graphable`` reads the device, the ambient mesh and the serve
    window, and nothing of the model's name."""
    from repro_torch.sharding import set_mesh

    cfg = tconfigs.get_config("granite-3-8b")
    cuda = torch.device("cuda")
    assert tserve.graphable(cfg, 4096, cuda)
    assert tserve.graphable(tconfigs.get_config("mamba2-2.7b"), 200_000, cuda)
    assert not tserve.graphable(cfg, 4096, torch.device("cpu"))
    assert tserve.serve_window(cfg, 70_000) and not tserve.graphable(cfg, 70_000, cuda)
    with set_mesh(object()):
        assert not tserve.graphable(cfg, 4096, cuda)


def test_loss_matches_jax():
    cfg_j, cfg_t, params_j, params_t, batch_j, batch_t = setup("yi-9b", "float32")
    labels = np.random.default_rng(8).integers(0, cfg_j.vocab_size, (B, S))
    batch_j["labels"], batch_t["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    want, mj = jmodel.loss_fn(params_j, batch_j, cfg_j)
    with torch.no_grad():
        got, mt = tmodel.loss_fn(params_t, batch_t, cfg_t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(mt["ce"]), float(mj["ce"]), rtol=1e-5)


def test_falcon_event_at_smoke_size_matches_reference_cli(capsys):
    """8 requests x (32 prompt + 64 generated) with ``gpu:1:0.5:0.003:200``:
    the reference CLI and the port's driver flag the same onset — token 24,
    gpu_degradation on gpu:1."""
    argv = ["--arch", "granite-3-8b", "--requests", "8", "--prompt-len", "32",
            "--gen", "64", "--inject", "gpu:1:0.5:0.003:200"]
    saved = sys.argv
    sys.argv = ["serve"] + argv
    try:
        jlaunch.main()
    finally:
        sys.argv = saved
    ref_lines = re.findall(r"token (\d+): FALCON flags (\w+) on (\[.*?\])",
                           capsys.readouterr().out)
    assert ref_lines == [("24", "gpu_degradation", "['gpu:1']")]

    cfg = tconfigs.get_config("granite-3-8b").smoke()
    params = tmodel.init_params(cfg, 0, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 32))
    res = tlaunch.serve(cfg, params, prompt, gen=64, inject=["gpu:1:0.5:0.003:200"],
                        device="cpu")
    got = [(str(step), ev.root_cause.value, str(ev.components)) for step, ev in res.events]
    assert got == ref_lines
    assert res.modeled and len(res.latencies) == 64


def test_serve_cli_runs_on_the_cpu(capsys):
    tlaunch.main(["--arch", "musicgen-large", "--requests", "2", "--prompt-len", "8",
                  "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sample continuation" in out and "musicgen-large-smoke" in out


def test_full_width_flag_parses():
    """``--smoke`` is a BooleanOptionalAction with the reference's default
    (``--no-smoke`` reaches the published width, which the reference's
    ``store_true`` with default True cannot)."""
    ap = tlaunch.build_parser()
    assert ap.parse_args([]).smoke is True
    assert ap.parse_args(["--no-smoke"]).smoke is False
    assert ap.parse_args(["--use-kernel"]).use_kernel is True


def test_unknown_sublayer_kind_raises():
    """Every sub-layer kind of ``configs/`` is ported (attention and Mamba2
    mixers, dense and MoE MLPs); any other kind is a bad config and raises
    ``ValueError``, naming it."""
    from repro_torch.configs.base import SubLayer

    cfg = tconfigs.get_config("jamba-1.5-large-398b").smoke()
    params = tmodel.init_params(cfg, 0, device="cpu")
    assert {k: sorted(v) for k, v in params["blocks"].items()}["sub0"] == ["mamba", "moe"]
    with pytest.raises(ValueError, match="unknown mlp 'ffn'"):
        tmodel.model_schema(replace(cfg, period=(SubLayer("attn", "ffn"),)))
    with pytest.raises(ValueError, match="unknown mixer 'rwkv'"):
        tmodel.model_schema(replace(cfg, period=(SubLayer("rwkv", "mlp"),)))
    with pytest.raises(ValueError, match="unknown mixer 'rwkv'"):
        ttransformer.init_caches(replace(cfg, period=(SubLayer("rwkv", None),)), 2, 8,
                                 device="cpu")
    cfg = tconfigs.get_config("granite-3-8b").smoke()
    caches = ttransformer.init_caches(cfg, 2, 8, device="cpu")
    assert caches["sub0"]["k"].shape == (cfg.n_periods, 2, 8, cfg.num_kv_heads,
                                         cfg.resolved_head_dim)


def test_every_config_builds():
    """No config in ``configs/`` raises for want of a ported module: each
    smoke model initialises, and the MoE ones hold their expert leaves."""
    for arch in tconfigs.list_archs():
        cfg = tconfigs.get_config(arch).smoke()
        params = tmodel.init_params(cfg, 0, device="cpu")
        moe = [sub for sub in cfg.period if sub.mlp == "moe"]
        blocks = params["blocks"]
        assert sum("moe" in entry for entry in blocks.values()) == len(moe), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    assert tcount(tmodel.model_schema(tconfigs.get_config(arch))) == \
        jcount(jmodel.model_schema(jconfigs.get_config(arch)))


@pytest.mark.parametrize("arch", ["granite-3-8b", "musicgen-large"])
def test_embedding_of_vocab_slices_sums_to_the_whole_and_checks_ids(arch):
    """A rank's slice of the token table embeds the ids in its rows and gives
    zero rows elsewhere, so the slices sum to the whole table's embedding,
    as JAX's; the whole table indexes as it is, so an id past the vocab
    raises."""
    from repro_torch.models import layers as tlayers

    cfg = replace(tconfigs.get_config(arch).smoke(), dtype="float32")
    params = {"tok": tmodel.init_params(cfg, 0, device="cpu")["embed"]["tok"].float()}
    vdim = 1 if cfg.modality == "audio_codes" else 0
    vocab = params["tok"].shape[vdim]
    shape = (2, 8, cfg.num_codebooks) if cfg.modality == "audio_codes" else (2, 8)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, vocab, shape))
    whole = tlayers.apply_embed(params, ids, cfg)
    want = jlayers.apply_embed({"tok": jnp.asarray(params["tok"].numpy())},
                               jnp.asarray(ids.numpy()),
                               replace(jconfigs.get_config(arch).smoke(), dtype="float32"))
    np.testing.assert_allclose(whole.numpy(), np.asarray(want, np.float32), rtol=0, atol=0)
    step = vocab // 4
    parts = sum(tlayers.apply_embed({"tok": params["tok"].narrow(vdim, r0, step)}, ids, cfg,
                                    row0=r0) for r0 in range(0, vocab, step))
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)
    with pytest.raises(IndexError):
        tlayers.apply_embed(params, ids + vocab, cfg)
