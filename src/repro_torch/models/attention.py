"""GQA attention — the twin of :mod:`repro.models.attention`: the blocked
(flash-style) training/prefill path and the cached decode path.

The default prefill path is a plain PyTorch *blocked online-softmax*
attention (a loop over KV blocks), so the full (S x S) score matrix is never
materialized. ``use_kernel=True`` routes prefill/forward attention through
the hand-written CUDA flash-attention kernel and the decode cache read
through the CUDA flash-decode kernel (:mod:`repro_torch.kernels.ops`; their
plain versions for tensors on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers
from repro_torch.models.schema import ParamDef, Schema

NEG_INF = -1e30


def attn_schema(cfg: ArchConfig) -> Schema:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {
        "norm": layers.rmsnorm_schema(d),
        "wq": ParamDef((d, h * hd), (None, "model")),
        "wk": ParamDef((d, kv * hd), (None, "model")),
        "wv": ParamDef((d, kv * hd), (None, "model")),
        "wo": ParamDef((h * hd, d), ("model", None)),
    }


# ------------------------------------------------------------------ core
def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks.

    q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) with H a multiple of KVH.
    ``window`` > 0 restricts attention to the last ``window`` keys
    (sliding-window). ``q_offset`` is the absolute position of q[0]
    (for decode/prefill continuation). The last block is cut at Skv rather
    than padded: padded keys are masked to -1e30 in the reference and add
    nothing to a row that has a real key.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = hd**-0.5

    # (B, KVH, rep, Sq, hd) grouped query layout; scaled in q's type, as
    # the reference does, then carried in float32.
    qg = (q.reshape(b, sq, kvh, rep, hd).permute(0, 2, 3, 1, 4) * scale).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, kvh, rep, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, rep, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, rep, sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, kv_block):
        kblk = k[:, k0:k0 + kv_block].permute(0, 2, 1, 3).float()  # (B, KVH, blk, hd)
        vblk = v[:, k0:k0 + kv_block].permute(0, 2, 1, 3).float()
        s = torch.einsum("bgrsd,bgkd->bgrsk", qg, kblk)
        k_pos = k0 + torch.arange(kblk.shape[2], device=q.device)
        mask = torch.ones((sq, kblk.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrsk,bgkd->bgrsd", p, vblk)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def _apply_positions(
    q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor | None, cfg: ArchConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    if cfg.pos_encoding == "rope":
        assert positions is not None
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_encoding == "mrope":
        assert positions is not None and positions.shape[0] == 3
        q = layers.apply_mrope(q, positions, cfg.rope_theta)
        k = layers.apply_mrope(k, positions, cfg.rope_theta)
    return q, k


def _project_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig, cols=None):
    """q, k, v as (B, S, heads, hd): the heads are the weights' columns
    (all of them, or a rank's). ``cols(t, name)``, where given, maps each
    flat projection before the split into heads (the sharded decode's
    all-gather of a projection's columns)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hn = layers.rmsnorm(x, params["norm"], cfg.norm_eps)
    out = []
    for w in ("wq", "wk", "wv"):
        t = layers.matmul(hn, params[w])
        out.append((cols(t, w) if cols else t).reshape(b, s, -1, hd))
    return tuple(out)


def attend(
    params: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor | None,
    *,
    window: int = 0,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training/prefill self-attention over the heads of ``params``'s
    columns (all, or a rank's). x: (B, S, D). Returns (out (B, S, D), k, v),
    k and v (B, S, KVH, hd) positioned: the prefill's cache rows."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    q, k = _apply_positions(q, k, positions, cfg)
    if use_kernel:
        out = kernel_ops.flash_attention(q, k, v, causal=True, window=window)
    else:
        out = blocked_attention(q, k, v, causal=True, window=window)
    return layers.matmul(out.reshape(b, s, -1), params["wo"]), k, v


def apply_attention(
    params: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor | None,
    *,
    window: int = 0,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Training/prefill self-attention. x: (B, S, D)."""
    return attend(params, x, cfg, positions, window=window, use_kernel=use_kernel)[0]


# ----------------------------------------------------------------- decode
def kv_cache_shape(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """``{"k": (shape, dtype), "v": (shape, dtype)}`` of one layer's cache."""
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    shape = (batch, max_len, kv, hd)
    dt = cfg.activation_dtype
    return {"k": (shape, dt), "v": (shape, dt)}


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    """Zeroed (B, max_len, KVH, hd) K and V caches on ``device`` (None =
    the card, raising when there is none)."""
    dev = resolve_device(device)
    return {
        name: torch.zeros(shape, dtype=dt, device=dev)
        for name, (shape, dt) in kv_cache_shape(cfg, batch, max_len).items()
    }


def decode_attention(
    params: dict,
    x: torch.Tensor,
    cache: dict,
    pos: int,
    cfg: ArchConfig,
    positions_full: torch.Tensor | None = None,
    *,
    window: int = 0,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); cache k/v: (B, S_max, KVH, hd);
    pos: the current position, a host int. Returns (out, cache).

    The new K/V row is written into ``cache`` IN PLACE (the returned dict
    holds the same tensors), where the reference's ``dynamic_update_slice``
    returns a new cache: a copy of the whole cache per layer per token would
    move ~1.4 GB per token at the full-width serve shape.

    With ``window`` > 0, only the trailing ``window`` cache entries are
    attended (sliding-window decode). ``use_kernel`` routes the cache read
    through the CUDA flash-decode kernel; its ``valid_len`` is computed on
    the host from ``pos`` (``pos + 1``, or ``pos + 1 - start`` in the window
    branch), so no layer waits on the device for it.
    """
    pos = int(pos)
    q, k_new, v_new = _project_qkv(params, x, cfg)
    q, k_new = rotate_at(q, k_new, pos, cfg)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, pos] = k_new[:, 0]
    v_cache[:, pos] = v_new[:, 0]
    out = read_cache(q, k_cache, v_cache, pos, window=window, use_kernel=use_kernel)
    return layers.matmul(out.to(x.dtype), params["wo"]), {"k": k_cache, "v": v_cache}


def rotate_at(q: torch.Tensor, k: torch.Tensor, pos: int, cfg: ArchConfig):
    """One token's q and k (B, 1, heads, hd) with the positional encoding
    of ``pos`` (a host int)."""
    b = q.shape[0]
    if cfg.pos_encoding == "rope":
        pos_arr = torch.full((b, 1), pos, dtype=torch.int32, device=q.device)
        q = layers.apply_rope(q, pos_arr, cfg.rope_theta)
        k = layers.apply_rope(k, pos_arr, cfg.rope_theta)
    elif cfg.pos_encoding == "mrope":
        pos_arr = torch.full((3, b, 1), pos, dtype=torch.int32, device=q.device)
        q = layers.apply_mrope(q, pos_arr, cfg.rope_theta)
        k = layers.apply_mrope(k, pos_arr, cfg.rope_theta)
    return q, k


def read_cache(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int, *,
    window: int = 0, use_kernel: bool = False,
) -> torch.Tensor:
    """One query row per sequence, q (B, 1, H, hd), over a whole-sequence
    cache (B, S_max, KVH, hd) whose positions 0..pos are written: the
    attention output (B, 1, H * hd), through ``flash_decode`` or the plain
    einsum read. The head counts are the tensors' (all heads, or a rank's)."""
    b, _, h, hd = q.shape
    kv, s_max = k_cache.shape[2], k_cache.shape[1]
    if window and window < s_max:
        # Slide: attend to the `window` keys ending at pos (static size).
        start = max(pos - window + 1, 0)
        k_att = k_cache[:, start:start + window]
        v_att = v_cache[:, start:start + window]
    else:
        start = 0
        k_att, v_att = k_cache, v_cache
    # Valid positions form a prefix of k_att in both branches.
    valid_len = pos + 1 - start

    if use_kernel:
        out = kernel_ops.flash_decode(q.reshape(b, h, hd), k_att, v_att, valid_len)
    else:
        rep = h // kv
        qg = q.reshape(b, kv, rep, hd).float() * hd**-0.5
        s = torch.einsum("bgrd,bkgd->bgrk", qg, k_att.float())
        valid = torch.arange(k_att.shape[1], device=q.device) < valid_len
        s = s.masked_fill(~valid, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bgrk,bkgd->bgrd", p, v_att.float())
    return out.reshape(b, 1, h * hd)
