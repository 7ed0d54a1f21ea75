"""The yardstick: the card's published peaks and the work of a step,
counted from the shapes and never from an implementation.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, without sparsity),
as the port's ``PERF.md`` kernel table uses them: 989 TFLOP/s in bfloat16
and 3.35 TB/s of HBM bandwidth, at the full 700 W power limit.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def matmul_params(sz: dict) -> float:
    """Parameters that take part in matrix products: every layer's
    projections and the head over the published vocabulary. The embedding
    is a lookup and the norms, biases and convolutions are not products."""
    d, v, n = sz["d"], sz["vocab"], sz["layers"]
    if sz["kind"] == "attn":
        hd, h, kv = sz["head_dim"], sz["heads"], sz["kv_heads"]
        layer = 2 * d * h * hd + 2 * d * kv * hd + 3 * d * sz["d_ff"]
    else:
        inner = sz["expand"] * d
        heads = inner // sz["head_dim"]
        layer = 3 * d * inner + d * 2 * sz["groups"] * sz["state"] + d * heads
    return n * layer + d * v


def mixer_flops_forward(sz: dict, seq_len: int) -> float:
    """Forward FLOPs of one sequence's token mixing, beyond the weights.

    Attention: the causal half of the score product Q K^T and of the value
    product P V, 2 * S^2 * H * hd a layer in all. Mamba2's SSD in chunks of
    Q: per head and chunk, C B^T and the masked product with x over the
    lower triangle, the chunk's state and the product with the state that
    enters it (the count of the port's ``PERF.md`` ``ssd_scan`` row)."""
    n = sz["layers"]
    if sz["kind"] == "attn":
        return n * 2.0 * seq_len * seq_len * sz["heads"] * sz["head_dim"]
    q, st, p = sz["chunk"], sz["state"], sz["head_dim"]
    heads = sz["expand"] * sz["d"] // p
    tri = q * (q + 1) // 2
    per = 2 * tri * st + 2 * tri * p + 4 * q * st * p
    return n * heads * (seq_len // q) * per


def train_step_flops(sz: dict, seq_len: int, sequences: int) -> float:
    """Model FLOPs of one training step: 6 * matmul parameters * tokens,
    and three times the forward token mixing (forward and backward), with
    no recompute counted."""
    tokens = seq_len * sequences
    return 6.0 * matmul_params(sz) * tokens + 3.0 * sequences * mixer_flops_forward(sz, seq_len)
