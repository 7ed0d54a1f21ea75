"""Granite-3.0-8B — GQA [hf:ibm-granite/granite-3.0-2b-base family]."""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    period=(SubLayer("attn", "mlp"),),
    pos_encoding="rope",
    rope_theta=1e4,
    sliding_window=4096,
    long_context="sliding",
    citation="hf:ibm-granite/granite-3.0-2b-base",
)
