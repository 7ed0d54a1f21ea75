"""The plain reference of a model's forward pass, in float32 (TF32 off),
with a control mode that computes every matrix product in fp8.

A model is its architecture's period of sub-layers, repeated: the module
``portbench/reference/arch/<architecture>.py`` gives the block function of
each sub-layer (see :mod:`portbench.reference.arch`), and this module runs
the embedding, each period's sub-layers in order, then the final RMSNorm,
the head over the published vocabulary (the padded columns the port masks
are left out) and the mean next-token cross-entropy. What the blocks share
is here: the precision, RMSNorm, rotary positions and the depthwise causal
convolution. The reference is written for clarity, not speed: each period
runs under activation checkpointing so that the 4,096-token layers fit.
"""
from __future__ import annotations

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


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd): each head's first half rotated against its
    second half by angle position * theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv)
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x (B, S, C), w (W, C); output t sums
    w[i] * x[t - W + 1 + i]."""
    width, c = w.shape
    xp = F.pad(x.transpose(1, 2), (width - 1, 0))
    return F.conv1d(xp, w.t().reshape(c, 1, width), groups=c).transpose(1, 2)


def _period(flat: dict, sz: dict):
    """The block function of each sub-layer of a period, each with the sorted
    names of its leaves under ``blocks/sub<j>/`` in ``flat``, and the number
    of periods."""
    blocks = sz["arch"].blocks(sz)
    names = [sorted(k[len(f"blocks/sub{j}/"):] for k in flat if k.startswith(f"blocks/sub{j}/"))
             for j in range(len(blocks))]
    return list(zip(blocks, names)), sz["layers"] // len(blocks)


def loss(w: dict, tokens: torch.Tensor, labels: torch.Tensor, sz: dict,
         prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy of one micro-batch. ``w`` holds the
    float32 weights by path (stacked blocks indexed by period here)."""
    vocab = sz["vocab"]
    subs, periods = _period(w, sz)

    def run(x, *ps):
        leaves = iter(ps)
        for j, (block, names) in enumerate(subs):
            if j:
                x = prec.store(x)
            x = block(x, {k: next(leaves) for k in names}, sz, prec)
        return x

    x = prec.store(w["embed/tok"][tokens.long()])
    for i in range(periods):
        period = [w[f"blocks/sub{j}/{k}"][i] for j, (_, names) in enumerate(subs) for k in names]
        x = prec.store(checkpoint(run, x, *period, use_reentrant=False))
    x = rmsnorm(x, w["final_norm"], sz["eps"])
    logits = prec.linear(x, w["head/w"][:, :vocab])
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean()


@torch.no_grad()
def logits(params: dict, tokens: torch.Tensor, sz: dict, prec: Precision) -> torch.Tensor:
    """Logits (B, S, vocab) of a whole sequence, from the bfloat16 weights
    by path, each sub-layer's cast to float32 as it is reached."""
    subs, periods = _period(params, sz)
    x = prec.store(params["embed/tok"][tokens.long()].float())
    for i in range(periods):
        for j, (block, names) in enumerate(subs):
            p = {k: params[f"blocks/sub{j}/{k}"][i].float() for k in names}
            x = prec.store(block(x, p, sz, prec))
    x = rmsnorm(x, params["final_norm"].float(), sz["eps"])
    return prec.linear(x, params["head/w"][:, : sz["vocab"]].float())
