"""Yi-9B — llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    period=(SubLayer("attn", "mlp"),),
    pos_encoding="rope",
    rope_theta=1e4,
    sliding_window=4096,
    long_context="sliding",
    citation="arXiv:2403.04652",
)
