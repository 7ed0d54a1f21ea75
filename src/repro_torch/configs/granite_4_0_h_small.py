"""Granite-4.0-H-Small (32B-A9B) — Mamba2 and NoPE GQA attention 9:1, a
72-expert top-10 MoE with a shared expert after every mixer
[hf:ibm-granite/granite-4.0-h-small].

Period of 10 layers: 5 Mamba2, 1 attention, 4 Mamba2 (attention at layers
5, 15, 25 and 35 of 40), each followed by the MoE. The router's softmax
over all 72 experts, its top 10 renormalised, equals the published softmax
over the chosen logits; every routed choice is computed (dropless). Scores
are scaled by ``attention_multiplier`` 1/128 and every mixer's and MoE's
output by ``residual_multiplier`` 0.22. The published load-balance loss is
added only when router logits are requested, so none is added here. The
embedding multiplier 12, logit divisor 16 and tied head are not applied.
"""
from repro_torch.configs.base import ArchConfig, SubLayer

_MAMBA = SubLayer("mamba", "moe")
_ATTN = SubLayer("attn", "moe")

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=0,  # every MLP is the MoE
    vocab_size=100352,
    head_dim=128,
    period=(_MAMBA,) * 5 + (_ATTN,) + (_MAMBA,) * 4,
    num_experts=72,
    top_k=10,
    moe_d_ff=768,
    num_shared_experts=1,
    shared_d_ff=1536,
    moe_dropless=True,
    aux_loss_coef=0.0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_conv_bias=True,
    pos_encoding="none",
    attention_multiplier=1 / 128,
    residual_multiplier=0.22,
    long_context="native",
    citation="hf:ibm-granite/granite-4.0-h-small",
)
