"""OLMoE-1B-7B — 64 experts, top-8 routing [arXiv:2409.02060]."""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,  # every MLP is MoE
    vocab_size=50304,
    period=(SubLayer("attn", "moe"),),
    num_experts=64,
    top_k=8,
    moe_d_ff=1024,
    moe_shard="experts",  # 64 % 16 == 0: expert-parallel over the model axis
    pos_encoding="rope",
    rope_theta=1e4,
    sliding_window=4096,
    long_context="sliding",
    citation="arXiv:2409.02060",
)
