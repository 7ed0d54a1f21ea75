"""Serve steps — the twin of :mod:`repro.serve.serve_step`: prefill (fill
caches, return last-token logits) and decode (one new token against a
``seq_len`` cache).

Sliding-window policy: architectures with ``long_context == "sliding"`` use
their configured window past 64k tokens of context (sub-quadratic
per-token cost AND bounded attention reads).

Prefill attention is the plain blocked attention, as in the reference (no
kernel); decode takes ``use_kernel`` to the CUDA flash-decode kernel.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, model as model_lib, transformer


def serve_window(cfg: ArchConfig, seq_len: int) -> int:
    """The attention window used when serving at this context length."""
    if cfg.long_context == "sliding" and cfg.sliding_window and seq_len > 65536:
        return cfg.sliding_window
    return 0


def make_decode_step(
    cfg: ArchConfig, seq_len: int, *, use_kernel: bool = False
) -> Callable:
    window = serve_window(cfg, seq_len)

    def decode_step(params, tokens, caches, pos):
        return model_lib.decode_step(
            params, tokens, caches, pos, cfg, window=window,
            use_kernel=use_kernel,
        )

    return decode_step


# ------------------------------------------------------------------ prefill
def make_prefill_step(cfg: ArchConfig, seq_len: int) -> Callable:
    """Forward over the prompt, returning (last-token logits, filled caches
    stacked over periods: (n_periods, B, S, KVH, hd))."""
    window = serve_window(cfg, seq_len)

    def prefill(params, batch):
        x = (
            batch["embeds"].to(cfg.activation_dtype)
            if cfg.modality == "vision_embeds"
            else layers.apply_embed(params["embed"], batch["tokens"], cfg)
        )
        positions = model_lib._positions(batch, cfg, x.shape[1])
        h = x
        per_period = []
        for i in range(cfg.n_periods):
            period = transformer.period_view(params["blocks"], i)
            cache_out = {}
            for j, sub in enumerate(cfg.period):
                key = f"sub{j}"
                p = period[key]
                if sub.mixer == "attn":
                    dh, c = _prefill_attention(p["attn"], h, cfg, positions, window)
                else:
                    dh, c = _prefill_mamba(p, h, cfg)
                h = h + dh
                cache_out[key] = c
                if sub.mlp == "mlp":
                    h = h + layers.apply_mlp(p["mlp"], h, cfg)
                elif sub.mlp is not None:
                    raise transformer.not_ported(sub.mlp)
            per_period.append(cache_out)
        caches = {
            key: {name: torch.stack([c[key][name] for c in per_period])
                  for name in per_period[0][key]}
            for key in per_period[0]
        }
        h = layers.rmsnorm(h, params["final_norm"], cfg.norm_eps)
        logits = layers.apply_head(params["head"], h[:, -1:], cfg)
        return logits, caches

    return prefill


def _prefill_attention(p, x, cfg, positions, window):
    b, s, _ = x.shape
    q, k, v = attention._project_qkv(p, x, cfg)
    q, k = attention._apply_positions(q, k, positions, cfg)
    out = attention.blocked_attention(q, k, v, causal=True, window=window)
    return out.reshape(b, s, -1) @ p["wo"], {"k": k, "v": v}


def _prefill_mamba(p, x, cfg):
    """Mamba prefill (the SSD scan) comes with the training slice."""
    raise transformer.not_ported("mamba")
