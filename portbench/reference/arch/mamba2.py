"""Mamba2, as the port runs it: a period of one Mamba2 block, no MLP.

RMSNorm, the z/x/B/C/dt projections, a depthwise causal convolution and
SiLU on x and on B/C, the selective scan in its quadratic (attention-like)
form over the whole sequence from a zero state, the per-head skip, the
gated RMSNorm and the out-projection. The port computes the scan in
chunks; this form shares none of its code. The decay rates and step-size
biases are drawn as mamba_ssm's ``Mamba2`` draws them, so that some heads
keep their state across many chunks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.lm import Precision, causal_conv, rmsnorm


def sizes(conf: dict) -> dict:
    """The sizes of a Mamba2 configuration file; those that ``config.json``
    does not give are under ``assumed``."""
    a = conf["assumed"]
    return {
        "kind": "mamba", "layers": conf["n_layer"], "d": conf["d_model"],
        "vocab": conf["vocab_size"], "eps": a["norm_eps"],
        "state": a["d_state"], "head_dim": a["headdim"], "expand": a["expand"],
        "groups": a["ngroups"], "conv": a["d_conv"], "chunk": a["chunk_size"],
        "a_range": tuple(a["A_init_range"]), "dt_range": (a["dt_min"], a["dt_max"]),
        "dt_floor": a["dt_init_floor"],
    }


def period(sz: dict) -> list[list[tuple]]:
    """One sub-layer: the Mamba2 mixer's leaves."""
    d = sz["d"]
    inner = sz["expand"] * d
    heads = inner // sz["head_dim"]
    bc = 2 * sz["groups"] * sz["state"]
    w = sz["conv"]
    return [[("mamba/norm", (d,), "ones", 0.02), ("mamba/w_z", (d, inner), "normal", 0.02),
             ("mamba/w_x", (d, inner), "normal", 0.02), ("mamba/w_bc", (d, bc), "normal", 0.02),
             ("mamba/w_dt", (d, heads), "normal", 0.02),
             ("mamba/dt_bias", (heads,), "dt_bias", 0.02),
             ("mamba/a_log", (heads,), "a_log", 0.02), ("mamba/d_skip", (heads,), "ones", 0.02),
             ("mamba/conv_x", (w, inner), "normal", 0.1), ("mamba/conv_bc", (w, bc), "normal", 0.1),
             ("mamba/out_norm", (inner,), "ones", 0.02), ("mamba/w_out", (inner, d), "normal", 0.02)]]


def _a_log(shape, sz: dict, gen, device) -> torch.Tensor:
    """``log(A)``, A uniform in ``a_range``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    lo, hi = sz["a_range"]
    return torch.log(lo + (hi - lo) * u)


def _dt_bias(shape, sz: dict, gen, device) -> torch.Tensor:
    """The inverse softplus of a step size log-uniform in ``dt_range``,
    floored at ``dt_floor``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    lo, hi = sz["dt_range"]
    dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u).clamp(min=sz["dt_floor"])
    return dt + torch.log(-torch.expm1(-dt))


#: mamba_ssm ``Mamba2``'s draws of the decay rates and step-size biases
INITS = {"a_log": _a_log, "dt_bias": _dt_bias}


def mamba_block(x, p, sz, prec: Precision):
    """One Mamba2 block. x (B, S, d) float32."""
    b, s, _ = x.shape
    inner = sz["expand"] * sz["d"]
    pd, g, n = sz["head_dim"], sz["groups"], sz["state"]
    h = inner // pd
    hn = rmsnorm(x, p["mamba/norm"], sz["eps"])
    z = prec.linear(hn, p["mamba/w_z"])
    xin = F.silu(causal_conv(prec.linear(hn, p["mamba/w_x"]), p["mamba/conv_x"]))
    bc = F.silu(causal_conv(prec.linear(hn, p["mamba/w_bc"]), p["mamba/conv_bc"]))
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


def blocks(sz: dict) -> list:
    return [mamba_block]


def matmul_params(sz: dict) -> int:
    """Every layer's z, x and out projections, B/C and dt."""
    d = sz["d"]
    inner = sz["expand"] * d
    heads = inner // sz["head_dim"]
    return sz["layers"] * (3 * d * inner + d * 2 * sz["groups"] * sz["state"] + d * heads)


def mixer_flops_forward(sz: dict, seq_len: int) -> int:
    """The SSD in chunks of Q: per head and chunk, C B^T and the masked
    product with x over the lower triangle, the chunk's state and the
    product with the state that enters it (the count of the port's
    ``PERF.md`` ``ssd_scan`` row)."""
    q, st, p = sz["chunk"], sz["state"], sz["head_dim"]
    heads = sz["expand"] * sz["d"] // p
    tri = q * (q + 1) // 2
    per = 2 * tri * st + 2 * tri * p + 4 * q * st * p
    return sz["layers"] * heads * (seq_len // q) * per


def port_fields(sz: dict) -> dict:
    return {"ssm_state": sz["state"], "ssm_head_dim": sz["head_dim"], "ssm_expand": sz["expand"],
            "ssm_groups": sz["groups"], "ssm_conv_width": sz["conv"], "ssm_chunk": sz["chunk"],
            "period": (("mamba", None),)}


def state_reset(sz: dict) -> int:
    """The SSD's chunk."""
    return sz["chunk"]
