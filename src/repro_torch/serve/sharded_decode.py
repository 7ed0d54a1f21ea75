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
* **Embedding**: vocab-sharded rows; each rank looks up the tokens in its
  rows, zeros elsewhere, and the rows are all-reduced over ``model``.
* **Head**: vocab-sharded columns; the logits stay sharded as
  ``logits_spec`` places them (padding columns masked by global index).
* **MoE**: the expert-parallel path of :mod:`repro_torch.models.moe` where
  it applies (its capacity is each data rank's, as the reference's
  ``shard_map``); otherwise the dispatch runs on the batch all-gathered
  over the DP axes, and experts sharded on their hidden dim ("ff") give
  partial outputs all-reduced over ``model``.
* **Mamba2** (no per-rank form in this slice): its parameters and its
  model-sharded cache leaves are all-gathered over ``model``, the step runs
  whole on every rank, and each rank keeps its slice of the new cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.attention import NEG_INF
from repro_torch.sharding import P
from repro_torch.sharding import partition as part
from repro_torch.sharding.manual import (
    all_gather, all_reduce, as_dtensor, axis_index, gather, is_dtensor, local_shard,
)


def _locals(tree, specs, mesh):
    """``(local tensors, specs)`` of a tree: a DTensor's own placements, a
    plain tensor sliced by ``specs``."""
    if not isinstance(tree, dict):
        spec = part.spec_of(tree) if is_dtensor(tree) else specs
        return local_shard(tree, spec, mesh), spec
    loc, sp = {}, {}
    for k, v in tree.items():
        loc[k], sp[k] = _locals(v, specs[k], mesh)
    return loc, sp


def _view(tree, i):
    """Period ``i`` of stacked local tensors / their specs (leading dim off)."""
    if isinstance(tree, P):
        return P(*tree[1:])
    if isinstance(tree, dict):
        return {k: _view(v, i) for k, v in tree.items()}
    return tree[i]


def _sharded(spec: P, dim: int) -> bool:
    return "model" in part.spec_axes(spec[dim])


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
    p_loc, p_spec = _locals(params, part.param_specs(cfg, mesh), mesh)
    tok_spec0 = part.decode_token_specs(cfg, mesh, b)
    tok_spec = part.spec_of(tokens) if is_dtensor(tokens) else tok_spec0
    tok = local_shard(tokens, tok_spec, mesh)
    c_loc, c_spec = _locals(caches, part.cache_specs(cfg, mesh, b), mesh)
    attn = [f"sub{j}" for j, sub in enumerate(cfg.period) if sub.mixer == "attn"]
    s_max = caches[attn[0]]["k"].shape[2] if attn else 0   # the global cache length

    x = _embed(p_loc["embed"], p_spec["embed"], tok, cfg, mesh)
    for i in range(cfg.n_periods):
        period, pspec = _view(p_loc["blocks"], i), _view(p_spec["blocks"], i)
        cache, cspec = _view(c_loc, i), _view(c_spec, i)
        for j, sub in enumerate(cfg.period):
            key = f"sub{j}"
            if sub.mixer == "attn":
                x = x + _attention(period[key]["attn"], pspec[key]["attn"], x,
                                   cache[key], cspec[key], pos, s_max, cfg, mesh,
                                   window, use_kernel)
            else:
                x = x + _mamba(period[key]["mamba"], pspec[key]["mamba"], x,
                               cache[key], cspec[key], cfg, mesh)
            if sub.mlp == "mlp":
                x = x + _mlp(period[key]["mlp"], pspec[key]["mlp"], x, cfg, mesh)
            elif sub.mlp == "moe":
                x = x + _moe(period[key]["moe"], pspec[key]["moe"], x, tok_spec, b, cfg,
                             mesh)
    x = layers.rmsnorm(x, p_loc["final_norm"], cfg.norm_eps)
    logits = _head(p_loc["head"], p_spec["head"], x, cfg, mesh)

    lspec = part.logits_spec(cfg, mesh, b)
    gshape = (b, 1, *((cfg.num_codebooks,) if cfg.modality == "audio_codes" else ()),
              cfg.padded_vocab)
    return as_dtensor(logits, lspec, mesh, shape=gshape), caches


# ------------------------------------------------------------- embed, head
def _embed(p, spec, tok, cfg: ArchConfig, mesh):
    if cfg.modality == "vision_embeds":
        return tok.to(cfg.activation_dtype)      # already embeddings
    table = p["tok"]
    audio = cfg.modality == "audio_codes"
    vdim = 1 if audio else 0
    if not _sharded(spec["tok"], vdim):
        return layers.apply_embed(p, tok, cfg)
    rows = table.shape[vdim]
    ids = tok.long() - axis_index(mesh, "model") * rows
    mine = (ids >= 0) & (ids < rows)
    ids = ids.clamp(0, rows - 1)
    if not audio:
        got = torch.where(mine[..., None], table[ids], 0)
        return all_reduce(got, "model", mesh).to(cfg.activation_dtype)
    # Each codebook's rows meet exactly (one rank holds each), then add in
    # codebook order, as the unsharded lookup adds them.
    got = torch.stack([torch.where(mine[..., k, None], table[k][ids[..., k]], 0)
                       for k in range(cfg.num_codebooks)])
    got = all_reduce(got, "model", mesh)
    out = got[0]
    for k in range(1, cfg.num_codebooks):
        out = out + got[k]
    return out.to(cfg.activation_dtype)


def _head(p, spec, x, cfg: ArchConfig, mesh):
    vdim = 2 if cfg.modality == "audio_codes" else 1
    cols = p["w"].shape[vdim]
    col0 = axis_index(mesh, "model") * cols if _sharded(spec["w"], vdim) else 0
    return layers.apply_head(p, x, cfg, col0=col0)


# ----------------------------------------------------------------- layers
def _row_parallel(y, sharded: bool, mesh):
    return all_reduce(y, "model", mesh) if sharded else y


def _mlp(p, spec, x, cfg: ArchConfig, mesh):
    return _row_parallel(layers.apply_mlp(p, x, cfg), _sharded(spec["wo"], 0), mesh)


def _moe(p, spec, x, tok_spec, batch: int, cfg: ArchConfig, mesh):
    hn = layers.rmsnorm(x, p["norm"], cfg.norm_eps)
    ep = moe._ep_axes(cfg)
    if ep is not None:
        _, ba, _ = ep
        if batch % part.mesh_axis_size(mesh, ba):
            ba = ()
        wspec, _ = moe.ep_specs(cfg, ba)
        for k, want in wspec.items():
            if spec[k] != want:
                raise ValueError(f"expert-parallel MoE: {k} placed {spec[k]}, needs {want}")
        return moe.moe_ep_local(p, hn, cfg, mesh, ba)[0]
    # Experts whole on every rank, or sharded on their hidden dim ("ff"):
    # the routed and the shared outputs are partial sums where their
    # weights are sharded. The dispatch sees the whole batch, as the
    # reference's (its capacity and drops are the batch's).
    bl, s, d = hn.shape
    batch_axes = part.spec_axes(tok_spec[0])
    if batch_axes:
        hn = all_gather(hn, batch_axes, mesh, 0)
    xf = hn.reshape(-1, d)
    y, _ = moe._moe_core(p, xf, cfg, 0, cfg.padded_experts)
    y = _row_parallel(y, _sharded(spec["wo"], 1), mesh).to(x.dtype)
    if cfg.num_shared_experts:
        y = y + _row_parallel(moe._shared(p, xf), _sharded(spec["shared_wo"], 0),
                              mesh).to(x.dtype)
    lo = axis_index(mesh, batch_axes) * bl
    return y.reshape(-1, s, d)[lo:lo + bl]


def _mamba(p, spec, x, cache, cspec, cfg: ArchConfig, mesh):
    full_p = {k: gather(v, _model_only(spec[k]), mesh) for k, v in p.items()}
    full_c = {k: gather(v, _model_only(cspec[k]), mesh) for k, v in cache.items()}
    dh, new = ssm.decode_mamba(full_p, x, full_c, cfg)
    sizes, coord = part.axis_sizes(mesh), part.coordinate(mesh)
    for k, t in new.items():
        cache[k].copy_(t[part.shard_slices(t.shape, _model_only(cspec[k]), sizes, coord)])
    return dh


def _model_only(spec: P) -> P:
    """``spec`` with only its ``model`` entries (the batch stays local)."""
    return P(*["model" if "model" in part.spec_axes(e) else None for e in spec])


def _attention(p, spec, x, cache, cspec, pos, s_max, cfg: ArchConfig, mesh, window,
               use_kernel):
    bl = x.shape[0]
    heads_local = _sharded(cspec["k"], 2)          # (B, S, KV, hd) per period
    seq_axes = part.spec_axes(cspec["k"][1])
    r = axis_index(mesh, "model")

    if heads_local:
        # The cache's KV heads divide the model axis, so do the query heads
        # and the projections' columns: a rank's columns are its heads.
        if not (all(_sharded(spec[w], 1) for w in ("wq", "wk", "wv"))
                and _sharded(spec["wo"], 0)):
            raise ValueError("a head-sharded cache needs wq/wk/wv/wo sharded over model")
        q, k_new, v_new = attention._project_qkv(p, x, cfg)
    else:
        # One token's projections, whole on every rank.
        q, k_new, v_new = attention._project_qkv(
            p, x, cfg, lambda t, w: all_gather(t, "model", mesh, -1) if _sharded(spec[w], 1)
            else t)
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
        return _row_parallel(layers.matmul(out, p["wo"]), True, mesh)
    if _sharded(spec["wo"], 0):
        rows = p["wo"].shape[0]
        return _row_parallel(layers.matmul(out[..., r * rows:(r + 1) * rows], p["wo"]),
                             True, mesh)
    return layers.matmul(out, p["wo"])
