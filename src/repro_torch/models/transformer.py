"""Decoder stack assembly — the twin of :mod:`repro.models.transformer`.

Architectures are expressed as a *period* (a fixed tuple of sub-layers)
repeated ``n_periods`` times, with parameters and caches stacked on a
leading period axis, the reference's layout. Where the reference runs a
``lax.scan`` over periods, the port runs a Python loop over views
``blocks[...][i]``.

Mixers are attention and Mamba2 (:mod:`repro_torch.models.ssm`). The
``moe`` MLP is not ported yet: it raises :class:`NotImplementedError`
(:data:`NOT_PORTED`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, SubLayer
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, ssm
from repro_torch.models.schema import Schema, stack

#: what a moe sub-layer raises until models/moe.py is ported
NOT_PORTED = (
    "{kind} sub-layers are not ported yet: models/moe.py is in ROADMAP.md, "
    "Queue 1, modules still missing"
)


def not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(NOT_PORTED.format(kind=kind))


def _check_sublayer(sub: SubLayer) -> None:
    if sub.mixer not in ("attn", "mamba"):
        raise not_ported(sub.mixer)
    if sub.mlp not in ("mlp", None):
        raise not_ported(sub.mlp)


def period_schema(cfg: ArchConfig) -> Schema:
    out: Schema = {}
    for j, sub in enumerate(cfg.period):
        _check_sublayer(sub)
        entry: Schema = {}
        if sub.mixer == "attn":
            entry["attn"] = attention.attn_schema(cfg)
        else:
            entry["mamba"] = ssm.mamba_schema(cfg)
        if sub.mlp == "mlp":
            entry["mlp"] = layers.mlp_schema(cfg)
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
    """Residual sub-layer application. Returns (x, aux_loss)."""
    _check_sublayer(sub)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if sub.mixer == "attn":
        x = x + attention.apply_attention(
            p["attn"], x, cfg, positions, window=window, use_kernel=use_kernel
        )
    else:
        x = x + ssm.apply_mamba(p["mamba"], x, cfg, use_kernel=use_kernel)
    if sub.mlp == "mlp":
        x = x + layers.apply_mlp(p["mlp"], x, cfg)
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

    With ``remat`` and autograd recording, each period runs under
    :func:`torch.utils.checkpoint.checkpoint`: only its input is kept, and
    the backward pass recomputes its activations (the reference's
    ``jax.checkpoint`` keeps the matrix products' outputs too; a full
    recompute gives the same numbers). Without autograd it changes
    nothing."""

    def period_body(h, aux_sum, period):
        for j, sub in enumerate(cfg.period):
            h, aux = _apply_sublayer(
                h, period[f"sub{j}"], sub, cfg, positions, window, use_kernel
            )
            aux_sum = aux_sum + aux
        return h, aux_sum

    recompute = remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_periods):
        period = period_view(blocks, i)
        if recompute:
            x, aux_total = checkpoint(
                period_body, x, aux_total, period, use_reentrant=False
            )
        else:
            x, aux_total = period_body(x, aux_total, period)
    return x, aux_total


# ----------------------------------------------------------------- decode
def cache_shapes(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Period-stacked ``(shape, dtype)`` of every cache leaf."""
    out: dict = {}
    for j, sub in enumerate(cfg.period):
        _check_sublayer(sub)
        if sub.mixer == "attn":
            leaves = attention.kv_cache_shape(cfg, batch, max_len)
        else:
            leaves = ssm.ssm_cache_shape(cfg, batch)
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
        _check_sublayer(sub)
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
    pos: int,
    cfg: ArchConfig,
    *,
    window: int = 0,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, dict]:
    """One-token decode through the stack. Returns (hidden, caches): the
    new K/V rows are written into ``caches`` in place (see
    :func:`repro_torch.models.attention.decode_attention`), the new SSM
    state and conv histories copied into their period's slots, and the
    same dict is returned."""
    for i in range(cfg.n_periods):
        period = period_view(blocks, i)
        cache = period_view(caches, i)
        for j, sub in enumerate(cfg.period):
            _check_sublayer(sub)
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
            x = x + dh
            if sub.mlp == "mlp":
                x = x + layers.apply_mlp(period[key]["mlp"], x, cfg)
    return x, caches
