"""MusicGen-large decoder over EnCodec tokens [arXiv:2306.05284].

Audio carve-out: the EnCodec codec is stubbed — inputs are 4 parallel
codebook token streams (B, S, K) which the model embeds and sums
(delay-pattern interleave handled by the data stub). One LM head per
codebook.
"""
from repro_torch.configs.base import ArchConfig, SubLayer

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    period=(SubLayer("attn", "mlp"),),
    pos_encoding="rope",
    sliding_window=4096,
    long_context="sliding",
    modality="audio_codes",
    num_codebooks=4,
    citation="arXiv:2306.05284",
)
