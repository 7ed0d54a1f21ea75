"""Plain PyTorch oracles of the model kernels — the twins of
``attention_ref``, ``decode_attention_ref`` and ``ssd_ref`` in
:mod:`repro.kernels.ref` (naive, obviously correct: the full score matrix
is materialized; the state-space recurrence runs one step at a time).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KVH, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Materialized-softmax GQA attention (the slow, trusted reference)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    kf = torch.repeat_interleave(k, rep, dim=2).float()
    vf = torch.repeat_interleave(v, rep, dim=2).float()
    qf = q.float() * hd**-0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window:
        mask &= rows - cols < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def valid_lengths(valid_len, b: int, device) -> torch.Tensor:
    """``valid_len`` (an int, a 0-d or a (B,) tensor) as a (B,) int32 tensor
    on ``device``."""
    lens = torch.as_tensor(valid_len, dtype=torch.int32, device=device)
    return torch.broadcast_to(lens, (b,))


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, hd) one token
    k: torch.Tensor,  # (B, Skv, KVH, hd)
    v: torch.Tensor,
    valid_len,  # int, () or (B,) int32
) -> torch.Tensor:
    """Single-token GQA attention over a masked cache (trusted reference).

    At ``valid_len = 0`` every score is masked and the softmax is uniform:
    the row is the mean of V, as in the JAX package's oracle."""
    b, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    kf = torch.repeat_interleave(k, rep, dim=2).float()
    vf = torch.repeat_interleave(v, rep, dim=2).float()
    qf = q.float() * hd**-0.5
    s = torch.einsum("bhd,bkhd->bhk", qf, kf)
    lens = valid_lengths(valid_len, b, q.device)
    mask = torch.arange(skv, device=q.device)[None, None, :] < lens[:, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, vf)
    return out.to(q.dtype)


def ssd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    a: torch.Tensor,  # (H,) negative
    b_mat: torch.Tensor,  # (B, S, G, N)
    c_mat: torch.Tensor,  # (B, S, G, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential state-space recurrence (the definitionally-correct form):

        S_t = exp(dt_t * a) * S_{t-1} + dt_t * x_t b_tᵀ
        y_t = C_t · S_t

    in float32; returns (y (B,S,H,P), final state (B,H,P,N)) in x's type."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    bh = torch.repeat_interleave(b_mat, rep, dim=2).float()  # (B,S,H,N)
    ch = torch.repeat_interleave(c_mat, rep, dim=2).float()
    xf = x.float()
    dtf = dt.float()
    af = a.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af)  # (B,H)
        state = state * decay[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], bh[:, t]
        )
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], state))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, h, p))
    return y.to(x.dtype), state.to(x.dtype)
