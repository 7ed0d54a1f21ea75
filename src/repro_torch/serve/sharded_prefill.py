"""The prefill step on a DeviceMesh: each rank computes on its local shards
with explicit collectives, where the reference lets GSPMD partition the
unsharded step (``jax.jit`` with ``in_shardings``).

Inputs are the global values: parameters placed by ``param_specs`` or
``fsdp_param_specs`` (DTensors; a plain tensor is taken as the same full
value on every rank and sliced by ``param_specs``), the batch by
``serve_batch_specs``. Where the batch does not divide the DP axes that
spec splits the prompt's *sequence* over them; the ranks then all-gather
it and every DP rank computes the whole batch (this slice has no
sequence-parallel attention or scan). The layers are the per-rank layers of
:mod:`repro_torch.models.sharded`, with the decode's layout: column-parallel
QKV and MLP-in, row-parallel out-projections, vocab-sharded embedding and
head, the expert-parallel MoE where it applies, Mamba2 on a rank's heads; an
FSDP weight is all-gathered over the DP axes at use, one period at a time.

Outputs: the last token's logits, a DTensor placed by ``logits_spec``, and
the caches, DTensors placed by ``cache_specs`` (``seq_shard`` as given),
sized to the prompt; :func:`grow_caches` pads them to the serving length
so that the sharded decode continues from them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, model as model_lib, transformer
from repro_torch.models import sharded as sh
from repro_torch.sharding import P
from repro_torch.sharding import partition as part
from repro_torch.sharding.manual import (
    all_gather, as_dtensor, is_dtensor, local_shard, split,
)


@torch.no_grad()
def prefill_step(params, batch: dict, cfg: ArchConfig, mesh, *, window: int = 0,
                 seq_shard: bool = True):
    """The prompt's forward on ``mesh``. Returns ``(logits, caches)`` as
    the module docstring says."""
    ref = batch["embeds"] if cfg.modality == "vision_embeds" else batch["tokens"]
    b, s = ref.shape[0], ref.shape[1]
    ba = part.batch_axes(mesh)
    tok_axes = ba if b % part.mesh_axis_size(mesh, ba) == 0 else ()
    bspecs = part.serve_batch_specs(cfg, mesh, b)
    local = {}
    for k, v in batch.items():
        spec = part.spec_of(v) if is_dtensor(v) else bspecs[k]
        t = local_shard(v, spec, mesh)
        for d, entry in enumerate(spec):
            if entry is not None and d != (1 if k == "positions" else 0):
                t = all_gather(t, entry, mesh, d)     # a split sequence, whole again
        local[k] = t
    p_loc, p_spec = sh.local_tree(params, part.param_specs(cfg, mesh), mesh)
    cspecs = part.cache_specs(cfg, mesh, b, seq_shard=seq_shard)
    cshapes = transformer.cache_shapes(cfg, b, s)

    x = sh.embed(*sh.use_tree(p_loc["embed"], p_spec["embed"], mesh),
                 local["embeds"] if cfg.modality == "vision_embeds" else local["tokens"],
                 cfg, mesh)
    positions = model_lib._positions(local, cfg, s)
    per_period = []
    for i in range(cfg.n_periods):
        period, pspec = sh.period(p_loc["blocks"], i), sh.period(p_spec["blocks"], i)
        out = {}
        for j, sub in enumerate(cfg.period):
            key = f"sub{j}"
            if sub.mixer == "attn":
                dh, k, v = sh.attention_step(
                    *sh.use_tree(period[key]["attn"], pspec[key]["attn"], mesh), x, cfg,
                    positions, window, mesh)
                made = {"k": k, "v": v}
            else:
                dh, made = sh.mamba(*sh.use_tree(period[key]["mamba"], pspec[key]["mamba"],
                                                 mesh), x, cfg, mesh)
            out[key] = {n: _take(t, P(*cspecs[key][n][1:]), cshapes[key][n][0][1:], mesh)
                        for n, t in made.items()}
            x = layers.residual(x, dh, cfg)
            if sub.mlp == "mlp":
                x = layers.residual(x, sh.mlp(*sh.use_tree(period[key]["mlp"], pspec[key]["mlp"],
                                                           mesh), x, cfg, mesh), cfg)
            elif sub.mlp == "moe":
                x = layers.residual(x, sh.moe(*sh.use_tree(period[key]["moe"], pspec[key]["moe"],
                                                           mesh), x, tok_axes, cfg, mesh)[0], cfg)
        per_period.append(out)
    final_norm, _ = sh.use(p_loc["final_norm"], p_spec["final_norm"], mesh)
    x = layers.rmsnorm(x, final_norm, cfg.norm_eps)
    logits = sh.head(*sh.use_tree(p_loc["head"], p_spec["head"], mesh), x[:, -1:], cfg,
                     mesh)
    caches = {key: {n: as_dtensor(torch.stack([c[key][n] for c in per_period]),
                                  cspecs[key][n], mesh, shape=cshapes[key][n][0])
                    for n in leaves}
              for key, leaves in per_period[0].items()}
    gshape = (b, 1, *((cfg.num_codebooks,) if cfg.modality == "audio_codes" else ()),
              cfg.padded_vocab)
    return as_dtensor(logits, part.logits_spec(cfg, mesh, b), mesh, shape=gshape), caches


def _take(t: torch.Tensor, spec: P, shape, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, where ``t`` is whole
    along the dims the spec splits and ``t`` is not already local (a dim
    of ``t`` shorter than ``shape``'s is this rank's already)."""
    for d, entry in enumerate(spec):
        if entry is not None and t.shape[d] == shape[d]:
            t = split(t, entry, mesh, d)
    return t.contiguous()


def grow_caches(caches: dict, cfg: ArchConfig, max_len: int, mesh) -> dict:
    """The sharded prefill's caches (DTensors) padded to ``max_len``
    positions, as :func:`repro_torch.models.transformer.grow_caches` pads
    whole ones: where the cache sequence is split over mesh axes it is
    all-gathered, padded and split again (each rank's slice of the longer
    sequence starts elsewhere)."""
    out: dict = {}
    for j, sub in enumerate(cfg.period):
        key = f"sub{j}"
        if sub.mixer != "attn":
            out[key] = caches[key]
            continue
        out[key] = {}
        for name, dt in caches[key].items():     # (periods, B, S, kv, hd)
            spec = part.spec_of(dt)
            t = dt.to_local()
            if spec[2] is not None:
                t = all_gather(t, spec[2], mesh, 2)
            t = F.pad(t, (0, 0, 0, 0, 0, max(max_len - t.shape[2], 0)))
            if spec[2] is not None:
                t = split(t, spec[2], mesh, 2)
            shape = (*dt.shape[:2], max(max_len, dt.shape[2]), *dt.shape[3:])
            out[key][name] = as_dtensor(t.contiguous(), spec, mesh, shape=shape)
    return out
