"""Granite-20B code model — llama-arch with MQA (kv=1) [arXiv:2405.04324]."""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    period=(SubLayer("attn", "mlp"),),
    pos_encoding="rope",
    rope_theta=1e4,
    sliding_window=4096,
    long_context="sliding",
    citation="arXiv:2405.04324",
)
