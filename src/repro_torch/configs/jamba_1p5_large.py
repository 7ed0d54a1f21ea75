"""Jamba-1.5-Large (398B) — Mamba+attention 1:7 interleave, 16-expert top-2
MoE on alternating layers [arXiv:2403.19887].

Period of 8 layers: 1 attention + 7 mamba; MoE MLP on every other layer.
TPU adaptation (see DESIGN.md): mamba layers use the SSD dual form
(MXU-friendly) rather than Mamba-1's sequential selective scan.
"""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    period=(
        SubLayer("mamba", "moe"),
        SubLayer("mamba", "mlp"),
        SubLayer("mamba", "moe"),
        SubLayer("mamba", "mlp"),
        SubLayer("attn", "moe"),
        SubLayer("mamba", "mlp"),
        SubLayer("mamba", "moe"),
        SubLayer("mamba", "mlp"),
    ),
    num_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_shard="experts",
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    pos_encoding="none",  # Jamba uses no positional encoding
    long_context="native",
    citation="arXiv:2403.19887",
)
