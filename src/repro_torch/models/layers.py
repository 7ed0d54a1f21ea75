"""Shared layers — the twin of :mod:`repro.models.layers`: RMSNorm, SwiGLU
MLP, RoPE / M-RoPE, embeddings and the LM head with its padded-vocab mask.

Each function does the reference's arithmetic in the reference's types
(statistics and rotations in float32, results cast back to the input's
type), on tensors on any device. Products of mixed types promote as JAX
does (bfloat16 weights against float32 activations compute in float32):
see :func:`matmul`.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.schema import ParamDef, Schema


# ------------------------------------------------------------ promotion
def promote(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The tensors in their common type, as JAX promotes the operands of a
    product (bfloat16 with float32 gives float32); no copy where the types
    agree. PyTorch's matrix products refuse mixed types."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return tuple(t.to(dt) for t in tensors)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the operands' common type."""
    x, w = promote(x, w)
    return x @ w


# --------------------------------------------------------------- RMSNorm
def rmsnorm_schema(d: int) -> ParamDef:
    return ParamDef((d,), (None,), init="ones")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * weight.float()).to(x.dtype)


# ----------------------------------------------------------- SwiGLU MLP
def mlp_schema(cfg: ArchConfig, d_ff: int | None = None) -> Schema:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "norm": rmsnorm_schema(d),
        "wi_gate": ParamDef((d, f), (None, "model")),
        "wi_up": ParamDef((d, f), (None, "model")),
        "wo": ParamDef((f, d), ("model", None)),
    }


def apply_mlp(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(x, params["norm"], cfg.norm_eps)
    gate = matmul(h, params["wi_gate"])
    up = matmul(h, params["wi_up"])
    return matmul(F.silu(gate) * up, params["wo"])


# ------------------------------------------------------------- RoPE(s)
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: broadcastable (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    return _rotate(x, angles[..., None, :])  # head axis


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Qwen2-VL M-RoPE: split the hd/2 rotary pairs into (t, h, w) sections
    with the 16/24/24-style 1:1.5:1.5 proportion."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    w = half - t - h
    return t, h, w


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float) -> torch.Tensor:
    """Multimodal RoPE. positions3: (3, ..., S) = (temporal, height, width)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    parts = []
    start = 0
    for i, sec in enumerate(mrope_sections(hd)):
        parts.append(positions3[i][..., None].float() * freqs[start:start + sec])
        start += sec
    angles = torch.cat(parts, dim=-1)[..., None, :]  # (..., S, 1, hd/2)
    return _rotate(x, angles)


# ---------------------------------------------------------- embeddings
def embed_schema(cfg: ArchConfig) -> Schema:
    v, d = cfg.padded_vocab, cfg.d_model
    if cfg.modality == "audio_codes":
        return {"tok": ParamDef((cfg.num_codebooks, v, d), (None, "model", None))}
    return {"tok": ParamDef((v, d), ("model", None))}


def lookup(table: torch.Tensor, ids: torch.Tensor, row0: int | None = None) -> torch.Tensor:
    """Rows of ``table`` for token ids. With ``row0`` the table holds the
    vocab rows ``row0 .. row0 + len(table)`` only (a rank's part of a
    vocab-sharded lookup) and ids outside them give zero rows; without it
    the table is whole and indexed as it is."""
    if row0 is None:
        return table[ids]
    rows = table.shape[0]
    local = ids.long() - row0
    mine = (local >= 0) & (local < rows)
    return torch.where(mine[..., None], table[local.clamp(0, rows - 1)], 0)


def apply_embed(
    params: dict, tokens: torch.Tensor, cfg: ArchConfig, row0: int | None = None
) -> torch.Tensor:
    """The embedding of ``tokens``; with ``row0``, ``params["tok"]`` holds
    the vocab rows from ``row0`` only (see :func:`lookup`)."""
    if cfg.modality == "audio_codes":
        # tokens: (B, S, K) -> sum of the K per-codebook embeddings
        # (MusicGen's delay-pattern interleave is the data stub's job).
        out = lookup(params["tok"][0], tokens[..., 0], row0)
        for k in range(1, cfg.num_codebooks):
            out = out + lookup(params["tok"][k], tokens[..., k], row0)
        return out.to(cfg.activation_dtype)
    return lookup(params["tok"], tokens, row0).to(cfg.activation_dtype)


def head_schema(cfg: ArchConfig) -> Schema:
    v, d = cfg.padded_vocab, cfg.d_model
    if cfg.modality == "audio_codes":
        return {"w": ParamDef((cfg.num_codebooks, d, v), (None, None, "model"))}
    return {"w": ParamDef((d, v), (None, "model"))}


def apply_head(params: dict, x: torch.Tensor, cfg: ArchConfig, col0: int = 0) -> torch.Tensor:
    """Returns logits over the padded vocab: (B,S,Vp) or (B,S,K,Vp).

    Padding columns are masked to a large negative so softmax/argmax/logsumexp
    never select them; the width stays ``padded_vocab`` as in the reference.
    ``col0`` is the vocab index of ``params["w"]``'s first column (a rank's
    columns of a vocab-sharded head).
    """
    if cfg.modality == "audio_codes":
        logits = torch.einsum("bsd,kdv->bskv", *promote(x, params["w"]))
    else:
        logits = matmul(x, params["w"])
    if cfg.padded_vocab != cfg.vocab_size:
        cols = logits.shape[-1]
        mask = torch.arange(col0, col0 + cols, device=logits.device) < cfg.vocab_size
        logits = logits.masked_fill(~mask, -1e9)
    return logits
