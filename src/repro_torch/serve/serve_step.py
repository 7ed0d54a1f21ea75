"""Serve steps — the twin of :mod:`repro.serve.serve_step`: prefill (fill
caches, return last-token logits) and decode (one new token against a
``seq_len`` cache).

Sliding-window policy: architectures with ``long_context == "sliding"`` use
their configured window past 64k tokens of context (sub-quadratic
per-token cost AND bounded attention reads).

Prefill runs the plain blocked attention and the plain chunked SSD scan,
as in the reference (no kernel); decode takes ``use_kernel`` to the CUDA
flash-decode kernel (a Mamba2 decode step is the recurrence, no kernel).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, model as model_lib, moe, ssm, transformer


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
    stacked over periods: (n_periods, B, S, KVH, hd) for attention, the
    final state and conv histories for Mamba2)."""
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
                    dh, c = _prefill_mamba(p["mamba"], h, cfg)
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


def _prefill_attention(p, x, cfg, positions, window):
    b, s, _ = x.shape
    q, k, v = attention._project_qkv(p, x, cfg)
    q, k = attention._apply_positions(q, k, positions, cfg)
    out = attention.blocked_attention(q, k, v, causal=True, window=window)
    return layers.matmul(out.reshape(b, s, -1), p["wo"]), {"k": k, "v": v}


def _prefill_mamba(p, x, cfg):
    b, s, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width

    hn = layers.rmsnorm(x, p["norm"], cfg.norm_eps)
    z = layers.matmul(hn, p["w_z"])
    xin_raw = layers.matmul(hn, p["w_x"])
    bc_raw = layers.matmul(hn, p["w_bc"])
    dt = F.softplus(layers.matmul(hn, p["w_dt"]) + p["dt_bias"])

    xin = F.silu(ssm.causal_conv(xin_raw, p["conv_x"]))
    bc = F.silu(ssm.causal_conv(bc_raw, p["conv_bc"]))
    b_mat, c_mat = torch.chunk(bc, 2, dim=-1)

    a = -torch.exp(p["a_log"].float())
    xh = xin.reshape(b, s, h, pd)
    y, final_state = ssm.ssd_scan(
        xh,
        dt,
        a,
        b_mat.reshape(b, s, g, n),
        c_mat.reshape(b, s, g, n),
        chunk=cfg.ssm_chunk,
    )
    y = y + p["d_skip"][:, None] * xh
    y = y.reshape(b, s, h * pd)
    y = layers.rmsnorm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    cache = {
        "state": final_state,
        "conv_x": xin_raw[:, -(w - 1) :],
        "conv_bc": bc_raw[:, -(w - 1) :],
    }
    return layers.matmul(y, p["w_out"]), cache
