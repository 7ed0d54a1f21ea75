"""Decoder stack assembly — the twin of :mod:`repro.models.transformer`.

Architectures are expressed as a *period* (a fixed tuple of sub-layers)
repeated ``n_periods`` times, with parameters and caches stacked on a
leading period axis, the reference's layout. Where the reference runs a
``lax.scan`` over periods, the port runs a Python loop over views
``blocks[...][i]``.

Mixers are attention and Mamba2 (:mod:`repro_torch.models.ssm`); MLPs the
dense SwiGLU and the mixture of experts (:mod:`repro_torch.models.moe`,
local dispatch). A sub-layer kind outside these raises :class:`ValueError`.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, SubLayer
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.schema import Schema, stack


def period_schema(cfg: ArchConfig) -> Schema:
    out: Schema = {}
    for j, sub in enumerate(cfg.period):
        entry: Schema = {}
        if sub.mixer == "attn":
            entry["attn"] = attention.attn_schema(cfg)
        elif sub.mixer == "mamba":
            entry["mamba"] = ssm.mamba_schema(cfg)
        else:
            raise ValueError(f"{cfg.name}: unknown mixer {sub.mixer!r} in sub{j}")
        if sub.mlp == "mlp":
            entry["mlp"] = layers.mlp_schema(cfg)
        elif sub.mlp == "moe":
            entry["moe"] = moe.moe_schema(cfg)
        elif sub.mlp is not None:
            raise ValueError(f"{cfg.name}: unknown mlp {sub.mlp!r} in sub{j}")
        out[f"sub{j}"] = entry
    return out


def blocks_schema(cfg: ArchConfig) -> Schema:
    return stack(period_schema(cfg), cfg.n_periods)


def period_view(tree: dict, i: int) -> dict:
    """Period ``i`` of a period-stacked tree: views, no copies."""
    return {
        name: period_view(sub, i) if isinstance(sub, dict) else sub[i]
        for name, sub in tree.items()
    }


def _apply_sublayer(
    x: torch.Tensor,
    p: dict,
    sub: SubLayer,
    cfg: ArchConfig,
    positions: torch.Tensor | None,
    window: int,
    use_kernel: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual sub-layer application (each output scaled by
    ``residual_multiplier``). Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if sub.mixer == "attn":
        dh = attention.apply_attention(
            p["attn"], x, cfg, positions, window=window, use_kernel=use_kernel
        )
    else:
        dh = ssm.apply_mamba(p["mamba"], x, cfg, use_kernel=use_kernel)
    x = layers.residual(x, dh, cfg)
    if sub.mlp == "mlp":
        x = layers.residual(x, layers.apply_mlp(p["mlp"], x, cfg), cfg)
    elif sub.mlp == "moe":
        y, aux = moe.apply_moe(p["moe"], x, cfg)
        x = layers.residual(x, y, cfg)
    return x, aux


def apply_blocks(
    blocks: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor | None,
    *,
    window: int = 0,
    use_kernel: bool = False,
    remat: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the full stack. Returns (hidden (B,S,D), total aux loss).

    With ``remat`` and autograd recording, each sub-layer (a mixer and its
    MLP) runs under :func:`torch.utils.checkpoint.checkpoint`: only its
    input is kept, and the backward pass recomputes its activations one
    sub-layer at a time, so a long period never holds all its sub-layers'
    activations at once (the reference's ``jax.checkpoint`` over a period
    keeps the matrix products' outputs too; a full recompute gives the same
    numbers). Without autograd it changes nothing."""
    recompute = remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_periods):
        period = period_view(blocks, i)
        for j, sub in enumerate(cfg.period):
            args = (x, period[f"sub{j}"], sub, cfg, positions, window, use_kernel)
            if recompute:
                x, aux = checkpoint(_apply_sublayer, *args, use_reentrant=False)
            else:
                x, aux = _apply_sublayer(*args)
            aux_total = aux_total + aux
    return x, aux_total


# ----------------------------------------------------------------- decode
def cache_shapes(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Period-stacked ``(shape, dtype)`` of every cache leaf."""
    out: dict = {}
    for j, sub in enumerate(cfg.period):
        if sub.mixer == "attn":
            leaves = attention.kv_cache_shape(cfg, batch, max_len)
        elif sub.mixer == "mamba":
            leaves = ssm.ssm_cache_shape(cfg, batch)
        else:
            raise ValueError(f"{cfg.name}: unknown mixer {sub.mixer!r} in sub{j}")
        out[f"sub{j}"] = {
            name: ((cfg.n_periods, *shape), dt) for name, (shape, dt) in leaves.items()
        }
    return out


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    """Zeroed period-stacked caches on ``device`` (None = the card, raising
    when there is none): attention (n_periods, B, max_len, KVH, hd), SSM
    state and conv histories (n_periods, B, ...)."""
    dev = resolve_device(device)
    return {
        key: {name: torch.zeros(shape, dtype=dt, device=dev)
              for name, (shape, dt) in leaves.items()}
        for key, leaves in cache_shapes(cfg, batch, max_len).items()
    }


def grow_caches(caches: dict, cfg: ArchConfig, max_len: int) -> dict:
    """Pad prefill-produced KV caches out to the serving context length.

    Prefill returns caches sized to the prompt; decode writes into a fixed
    ``max_len`` buffer indexed by ``pos``. SSM caches are O(1) in context
    length and pass through unchanged."""
    out: dict = {}
    for j, sub in enumerate(cfg.period):
        key = f"sub{j}"
        c = caches[key]
        if sub.mixer != "attn":
            out[key] = c
            continue
        pad = max(max_len - c["k"].shape[2], 0)  # (periods, B, S, kv, hd)
        out[key] = {
            name: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
            for name, t in c.items()
        }
    return out


def decode_blocks(
    blocks: dict,
    x: torch.Tensor,
    caches: dict,
    pos: int | torch.Tensor,
    cfg: ArchConfig,
    *,
    window: int = 0,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, dict]:
    """One-token decode through the stack at ``pos`` (a host int or a 0-d
    integer tensor on the device). Returns (hidden, caches): the
    new K/V rows are written into ``caches`` in place (see
    :func:`repro_torch.models.attention.decode_attention`), the new SSM
    state and conv histories copied into their period's slots, and the
    same dict is returned."""
    for i in range(cfg.n_periods):
        period = period_view(blocks, i)
        cache = period_view(caches, i)
        for j, sub in enumerate(cfg.period):
            key = f"sub{j}"
            if sub.mixer == "attn":
                dh, _ = attention.decode_attention(
                    period[key]["attn"], x, cache[key], pos, cfg,
                    window=window, use_kernel=use_kernel,
                )
            else:
                dh, new = ssm.decode_mamba(period[key]["mamba"], x, cache[key], cfg)
                for name, t in new.items():
                    cache[key][name].copy_(t)
            x = layers.residual(x, dh, cfg)
            if sub.mlp == "mlp":
                x = layers.residual(x, layers.apply_mlp(period[key]["mlp"], x, cfg), cfg)
            elif sub.mlp == "moe":
                y, _ = moe.apply_moe(period[key]["moe"], x, cfg)
                x = layers.residual(x, y, cfg)
    return x, caches
