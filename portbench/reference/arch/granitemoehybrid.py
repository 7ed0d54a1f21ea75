"""Granite-4.0-H (``granitemoehybrid``): a period of Mamba2 and attention
sub-layers as ``layer_types`` lists them, each followed by a mixture of
experts with a shared expert.

Each sub-layer: RMSNorm and its mixer, the output scaled by
``residual_multiplier`` and added to the stream; then RMSNorm and the MoE,
whose routed and shared parts are summed, scaled by ``residual_multiplier``
and added.

* Mamba2: the z/x/B/C/dt projections (no bias), the depthwise causal
  convolution with its bias (``mamba_conv_bias``) and SiLU on x and on B/C,
  the selective scan in its quadratic (attention-like) form over the whole
  sequence from a zero state, the per-head skip, the gated RMSNorm and the
  out-projection. The quadratic form runs in blocks of query rows, each
  under activation checkpointing, so that an 8,192-token layer fits.
* Attention: grouped-query causal attention with no positional encoding
  (``position_embedding_type`` ``nope``), scores scaled by
  ``attention_multiplier``, in checkpointed blocks of query rows.
* MoE: the router over every published expert, softmax, the top
  ``num_experts_per_tok`` renormalised (equal to the published softmax over
  the chosen logits), every choice computed (no capacity, no drop), as a
  loop over the held experts (``num_local_experts`` of the file, from
  ``expert_offset``) on the rows routed to each; one shared SwiGLU expert.
  A chip of the deployment holds a share of the experts: what the experts
  held elsewhere would add is left out, here as in the port.

Departures from the published model, as the port runs it (the
configuration file lists them): no embedding multiplier, no logit scaling,
an untied head (the shared :mod:`portbench.reference.lm` owns the
embedding and the head), and no load-balance term in the loss (the
published model adds one only when router logits are requested). The
decay rates and step-size biases are drawn as mamba_ssm's ``Mamba2``
draws them (:mod:`portbench.reference.arch.mamba2`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.arch import mamba2
from portbench.reference.lm import Precision, causal_conv, rmsnorm

#: query rows of one block of the Mamba2 scan and of the attention
MAMBA_ROWS = 256
ATTN_ROWS = 1024


def sizes(conf: dict) -> dict:
    """The sizes of a Granite-4.0-H configuration file; the draws of A and
    dt are under ``assumed``."""
    a = conf["assumed"]
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    kinds = tuple("attn" if t == "attention" else "mamba" for t in conf["layer_types"])
    return {
        "kind": "hybrid", "layers": conf["num_hidden_layers"], "d": d,
        "vocab": conf["vocab_size"], "eps": conf["rms_norm_eps"], "period": kinds,
        "heads": h, "kv_heads": conf["num_key_value_heads"], "head_dim": d // h,
        "attn_mult": conf["attention_multiplier"], "res_mult": conf["residual_multiplier"],
        "state": conf["mamba_d_state"], "ssm_head_dim": conf["mamba_d_head"],
        "expand": conf["mamba_expand"],
        "groups": conf["mamba_n_groups"], "conv": conf["mamba_d_conv"],
        "chunk": conf["mamba_chunk_size"],
        "a_range": tuple(a["A_init_range"]), "dt_range": (a["dt_min"], a["dt_max"]),
        "dt_floor": a["dt_init_floor"],
        "experts": conf["published"]["num_local_experts"], "held": conf["num_local_experts"],
        "expert_offset": conf["expert_offset"], "top_k": conf["num_experts_per_tok"],
        "d_ff": conf["intermediate_size"], "shared_d_ff": conf["shared_intermediate_size"],
        "aux_loss_coef": a["aux_loss_coef"],
    }


def _mamba_sizes(sz: dict) -> dict:
    """The sizes :mod:`portbench.reference.arch.mamba2` reads."""
    return {"d": sz["d"], "eps": sz["eps"], "state": sz["state"], "head_dim": sz["ssm_head_dim"],
            "expand": sz["expand"], "groups": sz["groups"], "conv": sz["conv"],
            "chunk": sz["chunk"], "a_range": sz["a_range"], "dt_range": sz["dt_range"],
            "dt_floor": sz["dt_floor"], "layers": sz["period"].count("mamba")}


def period(sz: dict) -> list[list[tuple]]:
    """Each sub-layer: its mixer's leaves (a Mamba2 block's with the
    convolution's biases, or the attention's), then the MoE's: its norm,
    the router over every expert, the held experts' and the shared
    expert's."""
    d, hd, h, kv = sz["d"], sz["head_dim"], sz["heads"], sz["kv_heads"]
    inner = sz["expand"] * d
    bc = 2 * sz["groups"] * sz["state"]
    e, f, fs = sz["held"], sz["d_ff"], sz["shared_d_ff"]
    mamba = mamba2.period(_mamba_sizes(sz))[0] + [
        ("mamba/conv_x_bias", (inner,), "normal", 0.1),
        ("mamba/conv_bc_bias", (bc,), "normal", 0.1)]
    attn = [("attn/norm", (d,), "ones", 0.02), ("attn/wq", (d, h * hd), "normal", 0.02),
            ("attn/wk", (d, kv * hd), "normal", 0.02), ("attn/wv", (d, kv * hd), "normal", 0.02),
            ("attn/wo", (h * hd, d), "normal", 0.02)]
    moe = [("moe/norm", (d,), "ones", 0.02), ("moe/router", (d, sz["experts"]), "normal", 0.02),
           ("moe/wi_gate", (e, d, f), "normal", 0.02), ("moe/wi_up", (e, d, f), "normal", 0.02),
           ("moe/wo", (e, f, d), "normal", 0.02),
           ("moe/shared_wi_gate", (d, fs), "normal", 0.02),
           ("moe/shared_wi_up", (d, fs), "normal", 0.02),
           ("moe/shared_wo", (fs, d), "normal", 0.02)]
    return [(attn if kind == "attn" else mamba) + moe for kind in sz["period"]]


#: mamba_ssm ``Mamba2``'s draws of the decay rates and step-size biases
INITS = {name: (lambda draw: lambda shape, sz, gen, device: draw(shape, _mamba_sizes(sz), gen,
                                                                 device))(draw)
         for name, draw in mamba2.INITS.items()}


def _scan_rows(r0, cm, bm, cum, dt, xh, prec: Precision):
    """Rows ``r0 .. r0 + MAMBA_ROWS`` of the quadratic form: each row's
    sum over the keys at or before it. cm (B, G, S, N), bm (B, G, N, S),
    cum (B, H, S), dt (B, H, S), xh (B, H, S, P)."""
    s, h = cum.shape[-1], cum.shape[1]
    r1 = min(r0 + MAMBA_ROWS, s)
    q = torch.arange(r0, r1, device=cum.device)
    k = torch.arange(r1, device=cum.device)
    causal = q[:, None] >= k[None, :]
    if prec.state_reset:
        causal &= (q[:, None] // prec.state_reset) == (k[None, :] // prec.state_reset)
    rel = (cum[..., r0:r1, None] - cum[..., None, :r1]).masked_fill(~causal, float("-inf"))
    cb = prec.mm(cm[:, :, r0:r1], bm[..., :r1]).repeat_interleave(h // cm.shape[1], dim=1)
    mix = cb * torch.exp(rel) * dt[:, :, None, :r1]
    return prec.mm(mix, xh[:, :, :r1])                                       # (B, H, R, P)


def _mamba(x, p, sz, prec: Precision):
    """The Mamba2 mixer's output (before the residual scale)."""
    b, s, _ = x.shape
    inner = sz["expand"] * sz["d"]
    pd, g, n = sz["ssm_head_dim"], sz["groups"], sz["state"]
    h = inner // pd
    hn = rmsnorm(x, p["mamba/norm"], sz["eps"])
    z = prec.linear(hn, p["mamba/w_z"])
    xin = F.silu(causal_conv(prec.linear(hn, p["mamba/w_x"]), p["mamba/conv_x"])
                 + p["mamba/conv_x_bias"])
    bc = F.silu(causal_conv(prec.linear(hn, p["mamba/w_bc"]), p["mamba/conv_bc"])
                + p["mamba/conv_bc_bias"])
    dt = F.softplus(prec.linear(hn, p["mamba/w_dt"]) + p["mamba/dt_bias"])   # (B, S, H)
    bm, cm = bc.split(g * n, dim=-1)
    bm = bm.reshape(b, s, g, n).permute(0, 2, 3, 1)                          # (B, G, N, S)
    cm = cm.reshape(b, s, g, n).permute(0, 2, 1, 3)                          # (B, G, S, N)
    a = -torch.exp(p["mamba/a_log"])                                          # (H,)
    cum = torch.cumsum(dt * a, dim=1).permute(0, 2, 1)                        # (B, H, S)
    dth = dt.permute(0, 2, 1)                                                 # (B, H, S)
    xh = xin.reshape(b, s, h, pd)
    xt = xh.permute(0, 2, 1, 3)                                               # (B, H, S, P)
    y = torch.cat([checkpoint(_scan_rows, r0, cm, bm, cum, dth, xt, prec, use_reentrant=False)
                   for r0 in range(0, s, MAMBA_ROWS)], dim=2).permute(0, 2, 1, 3)
    y = y + p["mamba/d_skip"][:, None] * xh
    y = rmsnorm(y.reshape(b, s, inner) * F.silu(z), p["mamba/out_norm"], sz["eps"])
    return prec.linear(y, p["mamba/w_out"])


def _attn_rows(r0, q, k, v, scale, prec: Precision):
    """Rows ``r0 .. r0 + ATTN_ROWS`` of causal attention: q (B, H, S, hd),
    k (B, H, hd, S), v (B, H, S, hd)."""
    s = q.shape[2]
    r1 = min(r0 + ATTN_ROWS, s)
    causal = (torch.arange(r0, r1, device=q.device)[:, None]
              >= torch.arange(r1, device=q.device)[None, :])
    scores = prec.mm(q[:, :, r0:r1], k[..., :r1]) * scale
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return prec.mm(probs, v[:, :, :r1])


def _attn(x, p, sz, prec: Precision):
    """NoPE grouped-query attention's output (before the residual scale)."""
    b, s, _ = x.shape
    h, kv, hd = sz["heads"], sz["kv_heads"], sz["head_dim"]
    hn = rmsnorm(x, p["attn/norm"], sz["eps"])
    q = prec.linear(hn, p["attn/wq"]).reshape(b, s, h, hd).permute(0, 2, 1, 3)
    k = prec.linear(hn, p["attn/wk"]).reshape(b, s, kv, hd)
    v = prec.linear(hn, p["attn/wv"]).reshape(b, s, kv, hd)
    rep = h // kv
    k = k.repeat_interleave(rep, dim=2).permute(0, 2, 3, 1)                   # (B, H, hd, S)
    v = v.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)                   # (B, H, S, hd)
    out = torch.cat([checkpoint(_attn_rows, r0, q, k, v, sz["attn_mult"], prec,
                                use_reentrant=False)
                     for r0 in range(0, s, ATTN_ROWS)], dim=2)
    return prec.linear(out.permute(0, 2, 1, 3).reshape(b, s, h * hd), p["attn/wo"])


def _swiglu(x, w_gate, w_up, w_out, prec: Precision):
    return prec.linear(F.silu(prec.linear(x, w_gate)) * prec.linear(x, w_up), w_out)


def _moe(x, p, sz, prec: Precision):
    """The MoE's output (before the residual scale): the held experts' part
    of the routed sum, dropless, plus the shared expert."""
    b, s, d = x.shape
    hn = rmsnorm(x, p["moe/norm"], sz["eps"]).reshape(b * s, d)
    probs = torch.softmax(prec.linear(hn, p["moe/router"]), dim=-1)
    top, idx = torch.topk(probs, sz["top_k"], dim=-1)
    gates = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(hn)
    for e in range(sz["held"]):
        weight = (gates * (idx == sz["expert_offset"] + e)).sum(-1)
        rows = torch.nonzero(weight).squeeze(1)
        out = _swiglu(hn[rows], p["moe/wi_gate"][e], p["moe/wi_up"][e], p["moe/wo"][e], prec)
        y = y.index_add(0, rows, out * weight[rows, None])
    y = y + _swiglu(hn, p["moe/shared_wi_gate"], p["moe/shared_wi_up"], p["moe/shared_wo"], prec)
    return y.reshape(b, s, d)


def _sublayer(mixer):
    def body(x, p, sz, prec: Precision):
        x = prec.store(x + sz["res_mult"] * mixer(x, p, sz, prec))
        return x + sz["res_mult"] * _moe(x, p, sz, prec)

    def block(x, p, sz, prec: Precision):
        """One sub-layer, under activation checkpointing of its own: a
        recompute of the period holds one sub-layer's inputs at a time."""
        return checkpoint(body, x, p, sz, prec, use_reentrant=False)

    return block


mamba_block = _sublayer(_mamba)
attn_block = _sublayer(_attn)


def blocks(sz: dict) -> list:
    return [attn_block if kind == "attn" else mamba_block for kind in sz["period"]]


def expected_held_choices(sz: dict) -> float:
    """A token's routed choices that land on the held experts, on average:
    top_k * held / experts."""
    return sz["top_k"] * sz["held"] / sz["experts"]


def expert_gemm_flops(sz: dict, held_choices: int, passes: int = 4) -> float:
    """FLOPs of the held experts' three products for ``held_choices``
    routed rows: 2 * 3 * d * expert width a row, over ``passes`` forwards'
    worth (a training step's forward, its recompute, and a backward of
    twice the forward)."""
    return passes * held_choices * 2.0 * 3 * sz["d"] * sz["d_ff"]


def matmul_params(sz: dict) -> float:
    """Every Mamba2 sub-layer's projections, every attention sub-layer's
    q, k, v and o, and each sub-layer's router, shared expert and held
    experts a token takes on average (:func:`expected_held_choices`)."""
    d, hd, h, kv = sz["d"], sz["head_dim"], sz["heads"], sz["kv_heads"]
    periods = sz["layers"] // len(sz["period"])
    n_attn = sz["period"].count("attn")
    moe = (d * sz["experts"] + 3 * d * sz["shared_d_ff"]
           + expected_held_choices(sz) * 3 * d * sz["d_ff"])
    per_period = (mamba2.matmul_params(_mamba_sizes(sz))
                  + n_attn * (2 * d * h * hd + 2 * d * kv * hd) + len(sz["period"]) * moe)
    return periods * per_period


def mixer_flops_forward(sz: dict, seq_len: int) -> float:
    """The chunked SSD of each Mamba2 sub-layer (the count of
    :mod:`portbench.reference.arch.mamba2`) and the causal halves of the
    score and value products of each attention sub-layer."""
    periods = sz["layers"] // len(sz["period"])
    attn = sz["period"].count("attn") * 2.0 * seq_len * seq_len * sz["heads"] * sz["head_dim"]
    return periods * (mamba2.mixer_flops_forward(_mamba_sizes(sz), seq_len) + attn)


def port_fields(sz: dict) -> dict:
    return {
        "num_heads": sz["heads"], "num_kv_heads": sz["kv_heads"], "head_dim": sz["head_dim"],
        "attention_multiplier": sz["attn_mult"], "residual_multiplier": sz["res_mult"],
        "pos_encoding": "none",
        "ssm_state": sz["state"], "ssm_head_dim": sz["ssm_head_dim"],
        "ssm_expand": sz["expand"], "ssm_groups": sz["groups"],
        "ssm_conv_width": sz["conv"], "ssm_chunk": sz["chunk"], "ssm_conv_bias": True,
        "num_experts": sz["experts"], "top_k": sz["top_k"], "moe_d_ff": sz["d_ff"],
        "num_shared_experts": 1, "shared_d_ff": sz["shared_d_ff"],
        "expert_offset": sz["expert_offset"], "held_experts": sz["held"],
        "moe_dropless": True, "aux_loss_coef": sz["aux_loss_coef"],
        "period": tuple((kind, "moe") for kind in sz["period"]),
    }


def state_reset(sz: dict) -> int:
    """The SSD's chunk."""
    return sz["chunk"]

