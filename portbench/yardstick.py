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
    """Parameters that take part in matrix products for a token: every
    period's, as the architecture's module counts them (an MoE its active
    experts), and the head over the published vocabulary. The embedding is
    a lookup and the norms, biases and convolutions are not products."""
    return sz["arch"].matmul_params(sz) + sz["d"] * sz["vocab"]


def train_step_flops(sz: dict, seq_len: int, sequences: int) -> float:
    """Model FLOPs of one training step: 6 * matmul parameters * tokens,
    and three times the forward token mixing (forward and backward; the
    architecture's ``mixer_flops_forward``), with no recompute counted."""
    tokens = seq_len * sequences
    mixing = sz["arch"].mixer_flops_forward(sz, seq_len)
    return 6.0 * matmul_params(sz) * tokens + 3.0 * sequences * mixing
