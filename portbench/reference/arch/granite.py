"""Granite, as the port runs it: a period of one pre-norm decoder block.

RMSNorm, grouped-query causal attention with rotary positions (the two
halves of a head rotated against each other, theta from the file), scores
scaled by the head size's inverse square root, then RMSNorm and a SwiGLU
MLP. The published Granite's embedding, attention, residual and logit
multipliers are not applied, and the head is untied, as the port runs it
(the configuration file lists both). Attention scores are materialised
whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.lm import Precision, rmsnorm, rope

#: no initialiser beyond normal and ones
INITS: dict = {}


def sizes(conf: dict) -> dict:
    """The sizes of a Granite configuration file."""
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return {
        "kind": "attn", "layers": conf["num_hidden_layers"], "d": d,
        "vocab": conf["vocab_size"], "eps": conf["rms_norm_eps"],
        "heads": h, "kv_heads": conf["num_key_value_heads"], "head_dim": d // h,
        "d_ff": conf["intermediate_size"], "rope_theta": conf["rope_theta"],
    }


def period(sz: dict) -> list[list[tuple]]:
    """One sub-layer: the attention's and the MLP's leaves."""
    d, hd, h, kv, f = sz["d"], sz["head_dim"], sz["heads"], sz["kv_heads"], sz["d_ff"]
    return [[("attn/norm", (d,), "ones", 0.02), ("attn/wq", (d, h * hd), "normal", 0.02),
             ("attn/wk", (d, kv * hd), "normal", 0.02), ("attn/wv", (d, kv * hd), "normal", 0.02),
             ("attn/wo", (h * hd, d), "normal", 0.02), ("mlp/norm", (d,), "ones", 0.02),
             ("mlp/wi_gate", (d, f), "normal", 0.02), ("mlp/wi_up", (d, f), "normal", 0.02),
             ("mlp/wo", (f, d), "normal", 0.02)]]


def attn_block(x, p, sz, prec: Precision):
    """One decoder block. x (B, S, d) float32; ``p`` the layer's float32
    weights by name."""
    b, s, _ = x.shape
    h, kv, hd = sz["heads"], sz["kv_heads"], sz["head_dim"]
    hn = rmsnorm(x, p["attn/norm"], sz["eps"])
    q = rope(prec.linear(hn, p["attn/wq"]).reshape(b, s, h, hd), sz["rope_theta"])
    k = rope(prec.linear(hn, p["attn/wk"]).reshape(b, s, kv, hd), sz["rope_theta"])
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


def blocks(sz: dict) -> list:
    return [attn_block]


def matmul_params(sz: dict) -> int:
    """Every layer's q, k, v and o projections and its three MLP matrices."""
    d, hd, h, kv = sz["d"], sz["head_dim"], sz["heads"], sz["kv_heads"]
    return sz["layers"] * (2 * d * h * hd + 2 * d * kv * hd + 3 * d * sz["d_ff"])


def mixer_flops_forward(sz: dict, seq_len: int) -> float:
    """The causal half of the score product Q K^T and of the value product
    P V: 2 * S^2 * H * hd a layer in all."""
    return sz["layers"] * 2.0 * seq_len * seq_len * sz["heads"] * sz["head_dim"]


def port_fields(sz: dict) -> dict:
    return {"num_heads": sz["heads"], "num_kv_heads": sz["kv_heads"], "head_dim": sz["head_dim"],
            "d_ff": sz["d_ff"], "rope_theta": sz["rope_theta"], "period": (("attn", "mlp"),)}


def state_reset(sz: dict) -> None:
    """No sub-layer scans."""
    return None
