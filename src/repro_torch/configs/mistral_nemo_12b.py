"""Mistral-Nemo-12B — 128k context GQA [hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,  # explicit: 5120 / 32 = 160, but Nemo uses 128
    period=(SubLayer("attn", "mlp"),),
    pos_encoding="rope",
    rope_theta=1e6,
    sliding_window=4096,
    long_context="sliding",
    citation="hf:mistralai/Mistral-Nemo-Base-2407",
)
