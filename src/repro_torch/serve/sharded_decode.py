"""The decode step on a DeviceMesh: each rank computes on its local shards
with explicit collectives, where the reference lets GSPMD partition the
unsharded step (``jax.jit`` with ``in_shardings``).

Inputs are the global values, placed as ``repro_torch.sharding.partition``
says: parameters by ``param_specs``, the token by ``decode_token_specs``,
the caches by ``cache_specs`` (with or without ``seq_shard``: the layout is
read from each cache DTensor's placements). The caches must be DTensors
(their shards are updated in place); a plain parameter or token tensor is
taken as the same full value on every rank and sliced. Per layer:

* **QKV / MLP-in, column parallel**: each rank multiplies by its columns.
  Where the cache shards the KV heads over ``model`` those columns are its
  heads; otherwise the projections are all-gathered over ``model`` (one
  token's q, k and v) and every rank attends with all heads.
* **The cache**: the new K/V row goes in place into the rank that holds
  position ``pos`` (its sequence slice, where the sequence is sharded).
  With a sequence-sharded cache, ``use_kernel=False`` combines the ranks'
  partial softmaxes (the row maxima, then the exp-weighted sums and
  values, all-reduced over the sequence's axes); ``use_kernel=True``
  all-gathers the layer's K/V slices first and runs ``flash_decode`` on
  the whole cache. Otherwise ``flash_decode`` (or the plain read) runs on
  the rank's local cache.
* **Out-projections, row parallel**: the partial products are
  all-reduced over ``model``.
* **Embedding, head, MLP, MoE**: the per-rank layers of
  :mod:`repro_torch.models.sharded` (vocab-sharded rows and columns, the
  logits left sharded as ``logits_spec`` places them; the expert-parallel
  MoE where it applies). Where the cache holds whole sequences and its own
  KV heads, the attention is the unsharded
  :func:`repro_torch.models.attention.decode_attention` on the rank's
  heads; this module keeps only the other layouts' cache write and the
  sequence-sharded partial-softmax combine.
* **Mamba2**: its parameters and model-sharded cache leaves are
  all-gathered over ``model``, the one-token step runs whole on every rank
  (one token's work; the prefill and train steps run a rank's heads), and
  each rank keeps its slice of the new cache.

Parameters may be placed by ``param_specs`` or ``fsdp_param_specs``: an
FSDP weight is all-gathered over the DP axes at use, one period at a time.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, ssm
from repro_torch.models import sharded as sh
from repro_torch.models.attention import NEG_INF
from repro_torch.sharding import partition as part
from repro_torch.sharding.manual import (
    all_gather, all_reduce, as_dtensor, axis_index, gather, is_dtensor, leave, local_shard,
)


def decode_step(
    params, tokens, caches, pos: int, cfg: ArchConfig, mesh, *, window: int = 0,
    use_kernel: bool = False,
):
    """One decode step on ``mesh``. Returns ``(logits, caches)``: the logits
    a DTensor placed by ``logits_spec``, the caches the same DTensors as
    given, their local shards updated in place."""
    if not all(is_dtensor(t) for c in caches.values() for t in c.values()):
        raise TypeError("the sharded decode updates its caches in place: pass DTensors "
                        "(repro_torch.sharding.partition.distribute)")
    pos = int(pos)
    b = tokens.shape[0]
    p_loc, p_spec = sh.local_tree(params, part.param_specs(cfg, mesh), mesh)
    tok_spec0 = part.decode_token_specs(cfg, mesh, b)
    tok_spec = part.spec_of(tokens) if is_dtensor(tokens) else tok_spec0
    tok = local_shard(tokens, tok_spec, mesh)
    tok_axes = part.spec_axes(tok_spec[0])
    c_loc, c_spec = sh.local_tree(caches, part.cache_specs(cfg, mesh, b), mesh)
    attn = [f"sub{j}" for j, sub in enumerate(cfg.period) if sub.mixer == "attn"]
    s_max = caches[attn[0]]["k"].shape[2] if attn else 0   # the global cache length

    x = sh.embed(*sh.use_tree(p_loc["embed"], p_spec["embed"], mesh), tok, cfg, mesh)
    for i in range(cfg.n_periods):
        period, pspec = sh.period(p_loc["blocks"], i), sh.period(p_spec["blocks"], i)
        cache, cspec = sh.period(c_loc, i), sh.period(c_spec, i)
        for j, sub in enumerate(cfg.period):
            key = f"sub{j}"
            if sub.mixer == "attn":
                x = x + _attention(*sh.use_tree(period[key]["attn"], pspec[key]["attn"], mesh),
                                   x, cache[key], cspec[key], pos, s_max, cfg, mesh,
                                   window, use_kernel)
            else:
                x = x + _mamba(*sh.use_tree(period[key]["mamba"], pspec[key]["mamba"], mesh),
                               x, cache[key], cspec[key], cfg, mesh)
            if sub.mlp == "mlp":
                x = x + sh.mlp(*sh.use_tree(period[key]["mlp"], pspec[key]["mlp"], mesh), x,
                               cfg, mesh)
            elif sub.mlp == "moe":
                x = x + sh.moe(*sh.use_tree(period[key]["moe"], pspec[key]["moe"], mesh), x,
                               tok_axes, cfg, mesh)[0]
    final_norm, _ = sh.use(p_loc["final_norm"], p_spec["final_norm"], mesh)
    x = layers.rmsnorm(x, final_norm, cfg.norm_eps)
    logits = sh.head(*sh.use_tree(p_loc["head"], p_spec["head"], mesh), x, cfg, mesh)

    lspec = part.logits_spec(cfg, mesh, b)
    gshape = (b, 1, *((cfg.num_codebooks,) if cfg.modality == "audio_codes" else ()),
              cfg.padded_vocab)
    return as_dtensor(logits, lspec, mesh, shape=gshape), caches


def _mamba(p, spec, x, cache, cspec, cfg: ArchConfig, mesh):
    full_p = sh.mamba_whole(p, spec, mesh)
    full_c = {k: gather(v, sh.model_only(cspec[k]), mesh) for k, v in cache.items()}
    dh, new = ssm.decode_mamba(full_p, x, full_c, cfg)
    sizes, coord = part.axis_sizes(mesh), part.coordinate(mesh)
    for k, t in new.items():
        cache[k].copy_(t[part.shard_slices(t.shape, sh.model_only(cspec[k]), sizes, coord)])
    return dh


def _attention(p, spec, x, cache, cspec, pos, s_max, cfg: ArchConfig, mesh, window,
               use_kernel):
    bl = x.shape[0]
    heads_local = sh.sharded(cspec["k"], 2)          # (B, S, KV, hd) per period
    seq_axes = part.spec_axes(cspec["k"][1])

    if heads_local and not seq_axes:
        # The cache's KV heads divide the model axis, so do the query heads
        # and the projections' columns: a rank's columns are its heads.
        if not (all(sh.sharded(spec[w], 1) for w in ("wq", "wk", "wv"))
                and sh.sharded(spec["wo"], 0)):
            raise ValueError("a head-sharded cache needs wq/wk/wv/wo sharded over model")
        out, _ = attention.decode_attention(p, x, cache, pos, cfg, window=window,
                                            use_kernel=use_kernel)
        return leave(out, "model", mesh)
    if heads_local:
        q, k_new, v_new = attention._project_qkv(p, x, cfg)
    else:
        # One token's projections, whole on every rank.
        q, k_new, v_new = attention._project_qkv(
            p, x, cfg, lambda t, w: all_gather(t, "model", mesh, -1)
            if sh.sharded(spec[w], 1) else t)
    q, k_new = attention.rotate_at(q, k_new, pos, cfg)

    k_cache, v_cache = cache["k"], cache["v"]
    s_loc = k_cache.shape[1]
    start = axis_index(mesh, seq_axes) * s_loc      # this rank's first position
    if start <= pos < start + s_loc:
        k_cache[:, pos - start] = k_new[:, 0]
        v_cache[:, pos - start] = v_new[:, 0]

    if seq_axes and use_kernel:
        k_cache = all_gather(k_cache, seq_axes, mesh, 1)
        v_cache = all_gather(v_cache, seq_axes, mesh, 1)
        seq_axes = ()
    if not seq_axes:
        out = attention.read_cache(q, k_cache, v_cache, pos, window=window,
                                   use_kernel=use_kernel)
    else:
        # Each rank's slice gives a partial softmax; combine over the
        # sequence's axes: the global row maximum, then the exp-weighted
        # sums of 1 and of V. The attended keys are positions lo..pos.
        _, _, hx, hd = q.shape
        kvx = k_cache.shape[2]
        lo = max(pos - window + 1, 0) if window and window < s_max else 0
        qg = q.reshape(bl, kvx, hx // kvx, hd).float() * hd**-0.5
        s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.float())
        g = start + torch.arange(s_loc, device=x.device)
        s = s.masked_fill(~((g >= lo) & (g <= pos)), NEG_INF)
        m = all_reduce(s.amax(dim=-1), seq_axes, mesh, op="max")
        e = torch.exp(s - m[..., None])
        l_sum = all_reduce(e.sum(dim=-1), seq_axes, mesh)
        acc = all_reduce(torch.einsum("bgrk,bkgd->bgrd", e, v_cache.float()), seq_axes, mesh)
        out = (acc / l_sum[..., None]).reshape(bl, 1, hx * hd)
    out = out.to(x.dtype)

    if heads_local:
        return leave(layers.matmul(out, p["wo"]), "model", mesh)
    if sh.sharded(spec["wo"], 0):
        rows = p["wo"].shape[0]
        r = axis_index(mesh, "model")
        return leave(layers.matmul(out[..., r * rows:(r + 1) * rows], p["wo"]), "model", mesh)
    return layers.matmul(out, p["wo"])
