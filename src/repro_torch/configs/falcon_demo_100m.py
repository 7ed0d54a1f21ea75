"""~100M dense model for the end-to-end FALCON training examples."""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="falcon-demo-100m",
    family="dense",
    num_layers=8,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    period=(SubLayer("attn", "mlp"),),
    pos_encoding="rope",
    rope_theta=1e4,
    citation="(demo model for examples/)",
)
