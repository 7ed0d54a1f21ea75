"""The plain reference of the two block kinds the configurations run, in
float32 (TF32 off), with a control mode that computes every matrix product
in fp8.

* ``attn``: a pre-norm decoder block, as the port runs Granite: RMSNorm,
  grouped-query causal attention with rotary positions (the two halves of a
  head rotated against each other, theta from the file), scores scaled by
  the head size's inverse square root, then RMSNorm and a SwiGLU MLP. The
  published Granite's embedding, attention, residual and logit multipliers
  are not applied, and the head is untied, as the port runs it (the
  configuration file lists both).
* ``mamba``: a Mamba2 block: RMSNorm, the z/x/B/C/dt projections, a
  depthwise causal convolution and SiLU on x and on B/C, the selective scan
  in its quadratic (attention-like) form over the whole sequence from a zero
  state, the per-head skip, the gated RMSNorm and the out-projection. The
  port computes the scan in chunks; this form shares none of its code.

Then the final RMSNorm, the head over the published vocabulary (the padded
columns the port masks are left out) and the mean next-token cross-entropy.
Attention scores are materialised whole: the reference is written for
clarity, not speed. Each layer runs under activation checkpointing so that
the 4,096-token layers fit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor,
    returned in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to fp8, and the backward's
    products too (an fp8 training recipe)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Precision:
    """``"f32"``: float32 throughout; ``"fp8"``: the control, every
    product's operands and the residual stream rounded to fp8.
    ``state_reset``: a fault, the Mamba2 scan's state dropped at every
    boundary of chunks of that length, as if nothing crossed between them."""

    def __init__(self, name: str, state_reset: int | None = None) -> None:
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.state_reset = state_reset

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as this precision keeps it between layers: the
        control rounds the residual stream to fp8 too."""
        if self.name == "fp8":
            return x + (_fp8(x) - x).detach()
        return x

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for activations (..., d) and a weight (d, f)."""
        lead = x.shape[:-1]
        return self.mm(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[-1])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd): each head's first half rotated against its
    second half by angle position * theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv)
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attn_block(x, p, sz, prec: Precision):
    """One decoder block. x (B, S, d) float32; ``p`` the layer's float32
    weights by name."""
    b, s, _ = x.shape
    h, kv, hd = sz["heads"], sz["kv_heads"], sz["head_dim"]
    hn = rmsnorm(x, p["attn/norm"], sz["eps"])
    q = _rope(prec.linear(hn, p["attn/wq"]).reshape(b, s, h, hd), sz["rope_theta"])
    k = _rope(prec.linear(hn, p["attn/wk"]).reshape(b, s, kv, hd), sz["rope_theta"])
    v = prec.linear(hn, p["attn/wv"]).reshape(b, s, kv, hd)
    rep = h // kv
    q = q.permute(0, 2, 1, 3)                                   # (B, H, S, hd)
    k = k.repeat_interleave(rep, dim=2).permute(0, 2, 3, 1)     # (B, H, hd, S)
    v = v.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)     # (B, H, S, hd)
    scores = prec.mm(q, k) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = prec.mm(probs, v).permute(0, 2, 1, 3).reshape(b, s, h * hd)
    x = prec.store(x + prec.linear(out, p["attn/wo"]))
    hn = rmsnorm(x, p["mlp/norm"], sz["eps"])
    gate = prec.linear(hn, p["mlp/wi_gate"])
    up = prec.linear(hn, p["mlp/wi_up"])
    return x + prec.linear(F.silu(gate) * up, p["mlp/wo"])


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x (B, S, C), w (W, C); output t sums
    w[i] * x[t - W + 1 + i]."""
    width, c = w.shape
    xp = F.pad(x.transpose(1, 2), (width - 1, 0))
    return F.conv1d(xp, w.t().reshape(c, 1, width), groups=c).transpose(1, 2)


def mamba_block(x, p, sz, prec: Precision):
    """One Mamba2 block. x (B, S, d) float32."""
    b, s, _ = x.shape
    inner = sz["expand"] * sz["d"]
    pd, g, n = sz["head_dim"], sz["groups"], sz["state"]
    h = inner // pd
    hn = rmsnorm(x, p["mamba/norm"], sz["eps"])
    z = prec.linear(hn, p["mamba/w_z"])
    xin = F.silu(_causal_conv(prec.linear(hn, p["mamba/w_x"]), p["mamba/conv_x"]))
    bc = F.silu(_causal_conv(prec.linear(hn, p["mamba/w_bc"]), p["mamba/conv_bc"]))
    dt = F.softplus(prec.linear(hn, p["mamba/w_dt"]) + p["mamba/dt_bias"])   # (B, S, H)
    bm, cm = bc.split(g * n, dim=-1)
    bm = bm.reshape(b, s, g, n).permute(0, 2, 3, 1)                          # (B, G, N, S)
    cm = cm.reshape(b, s, g, n).permute(0, 2, 1, 3)                          # (B, G, S, N)
    a = -torch.exp(p["mamba/a_log"])                                          # (H,)
    cum = torch.cumsum(dt * a, dim=1).permute(0, 2, 1)                        # (B, H, S)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    if prec.state_reset:
        block = torch.arange(s, device=x.device) // prec.state_reset
        causal &= block[:, None] == block[None, :]
    rel = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, float("-inf"))
    cb = prec.mm(cm, bm).repeat_interleave(h // g, dim=1)                     # (B, H, S, S)
    mix = cb * torch.exp(rel) * dt.permute(0, 2, 1)[:, :, None, :]
    xh = xin.reshape(b, s, h, pd)
    y = prec.mm(mix, xh.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)              # (B, S, H, P)
    y = y + p["mamba/d_skip"][:, None] * xh
    y = rmsnorm(y.reshape(b, s, inner) * F.silu(z), p["mamba/out_norm"], sz["eps"])
    return x + prec.linear(y, p["mamba/w_out"])


BLOCKS = {"attn": attn_block, "mamba": mamba_block}


def loss(w: dict, tokens: torch.Tensor, labels: torch.Tensor, sz: dict,
         prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy of one micro-batch. ``w`` holds the
    float32 weights by path (stacked blocks indexed by layer here)."""
    vocab = sz["vocab"]
    block = BLOCKS[sz["kind"]]
    names = sorted(k[len("blocks/sub0/"):] for k in w if k.startswith("blocks/"))
    x = prec.store(w["embed/tok"][tokens.long()])
    for i in range(sz["layers"]):
        layer = [w["blocks/sub0/" + k][i] for k in names]

        def run(x, *ps):
            return block(x, dict(zip(names, ps)), sz, prec)

        x = prec.store(checkpoint(run, x, *layer, use_reentrant=False))
    x = rmsnorm(x, w["final_norm"], sz["eps"])
    logits = prec.linear(x, w["head/w"][:, :vocab])
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean()


@torch.no_grad()
def logits(params: dict, tokens: torch.Tensor, sz: dict, prec: Precision) -> torch.Tensor:
    """Logits (B, S, vocab) of a whole sequence, from the bfloat16 weights
    by path, each layer's cast to float32 as it is reached."""
    block = BLOCKS[sz["kind"]]
    names = sorted(k[len("blocks/sub0/"):] for k in params if k.startswith("blocks/"))
    x = prec.store(params["embed/tok"][tokens.long()].float())
    for i in range(sz["layers"]):
        x = prec.store(block(x, {k: params["blocks/sub0/" + k][i].float() for k in names}, sz, prec))
    x = rmsnorm(x, params["final_norm"].float(), sz["eps"])
    return prec.linear(x, params["head/w"][:, : sz["vocab"]].float())
