"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].

60 experts do not divide the 16-way model axis; the expert dim is padded to
64 (router-masked dummies, EXPERIMENTS §Perf) so the expert-parallel
shard_map path applies — +6.7 % expert-weight memory for shard-local
dispatch. (The previous layout, ``moe_shard="ff"``, tensor-parallelized the
1408-wide FF *within* each expert and replicated the capacity buffers.)
"""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=151936,
    period=(SubLayer("attn", "moe"),),
    num_experts=60,
    top_k=4,
    moe_d_ff=1408,
    num_shared_experts=4,
    shared_d_ff=5632,
    moe_shard="experts",
    pad_experts_to=64,
    pos_encoding="rope",
    rope_theta=1e6,
    sliding_window=4096,
    long_context="sliding",
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
