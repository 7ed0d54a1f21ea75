"""Serve steps — the twin of :mod:`repro.serve.serve_step`: prefill (fill
caches, return last-token logits) and decode (one new token against a
``seq_len`` cache).

Sliding-window policy: architectures with ``long_context == "sliding"`` use
their configured window past 64k tokens of context (sub-quadratic
per-token cost AND bounded attention reads).

Prefill runs the plain blocked attention and the plain chunked SSD scan,
as in the reference (no kernel); decode takes ``use_kernel`` to the CUDA
flash-decode kernel (a Mamba2 decode step is the recurrence, no kernel).

Under an ambient mesh (:func:`repro_torch.sharding.set_mesh`) both steps
run per rank on local shards with explicit collectives
(:mod:`repro_torch.serve.sharded_prefill`,
:mod:`repro_torch.serve.sharded_decode`).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, model as model_lib, moe, ssm, transformer
from repro_torch.sharding import ambient_mesh


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
        mesh = ambient_mesh()
        if mesh is not None:
            from repro_torch.serve import sharded_decode

            return sharded_decode.decode_step(
                params, tokens, caches, pos, cfg, mesh, window=window,
                use_kernel=use_kernel,
            )
        return model_lib.decode_step(
            params, tokens, caches, pos, cfg, window=window,
            use_kernel=use_kernel,
        )

    return decode_step


# ------------------------------------------------------------------ prefill
def make_prefill_step(cfg: ArchConfig, seq_len: int, *, seq_shard: bool = True) -> Callable:
    """Forward over the prompt, returning (last-token logits, filled caches
    stacked over periods: (n_periods, B, S, KVH, hd) for attention, the
    final state and conv histories for Mamba2). Under an ambient mesh the
    caches come placed by ``cache_specs(..., seq_shard=seq_shard)``."""
    window = serve_window(cfg, seq_len)

    def prefill(params, batch):
        mesh = ambient_mesh()
        if mesh is not None:
            from repro_torch.serve import sharded_prefill

            return sharded_prefill.prefill_step(params, batch, cfg, mesh, window=window,
                                                seq_shard=seq_shard)
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
                    dh, k, v = attention.attend(p["attn"], h, cfg, positions, window=window)
                    c = {"k": k, "v": v}
                else:
                    dh, c = ssm.mamba_forward(p["mamba"], h, cfg)
                h = h + dh
                cache_out[key] = c
                if sub.mlp == "mlp":
                    h = h + layers.apply_mlp(p["mlp"], h, cfg)
                elif sub.mlp == "moe":
                    y, _ = moe.apply_moe(p["moe"], h, cfg)
                    h = h + y
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
