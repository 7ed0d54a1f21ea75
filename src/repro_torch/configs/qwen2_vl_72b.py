"""Qwen2-VL-72B language backbone [arXiv:2409.12191].

VLM carve-out: the ViT vision encoder + projector are stubbed —
``input_specs`` feeds precomputed patch/text embeddings (B, S, D) plus
M-RoPE (temporal, height, width) position ids.
"""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    period=(SubLayer("attn", "mlp"),),
    pos_encoding="mrope",
    rope_theta=1e6,
    sliding_window=4096,
    long_context="sliding",
    modality="vision_embeds",
    citation="arXiv:2409.12191",
)
