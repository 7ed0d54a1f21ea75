"""Architecture configuration schema + registry — the twin of
:mod:`repro.configs.base`.

Each assigned architecture gets one ``src/repro_torch/configs/<id>.py``
exporting ``CONFIG`` (the same data as the JAX package's). Models are built
from a *period*: the repeating pattern of sub-layers (e.g. jamba = 1
attention + 7 mamba per 8 layers); parameters are stacked over periods and
the port walks them with a Python loop.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

import torch

#: weight of the MoE load-balance loss in the training loss, unless a
#: configuration gives its own (``ArchConfig.aux_loss_coef``)
AUX_LOSS_COEF = 0.01

#: input shapes assigned to this paper (global batch, seq_len, kind)
INPUT_SHAPES: dict[str, dict] = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}


@dataclass(frozen=True)
class SubLayer:
    """One sub-layer of the repeating period."""

    mixer: str  # "attn" | "mamba"
    mlp: str | None  # "mlp" | "moe" | None (mamba2 blocks carry no MLP)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    period: tuple[SubLayer, ...] = (SubLayer("attn", "mlp"),)

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden width (d_ff is the dense-MLP width)
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    #: "experts" = expert-parallel (E % tp == 0), "ff" = TP within experts
    moe_shard: str = "experts"
    #: pad the routed-expert count up to this (0 = no padding). Dummy
    #: experts are masked in the router and never receive tokens; padding
    #: 60 -> 64 lets qwen2-moe use the expert-parallel path (EXPERIMENTS
    #: §Perf) at +6.7 % expert-weight memory.
    pad_experts_to: int = 0
    #: this chip's share of the routed experts under expert parallelism:
    #: experts ``expert_offset .. expert_offset + held_experts`` (0 = all).
    #: The router keeps every expert's column; only the held experts'
    #: weights are here and only their routed rows are computed.
    expert_offset: int = 0
    held_experts: int = 0
    #: route every choice (no capacity, no drop) through grouped products
    #: over the held experts' routed rows, instead of the capacity buffer
    moe_dropless: bool = False
    #: weight of the load-balance loss in the training loss (0: none added)
    aux_loss_coef: float = AUX_LOSS_COEF

    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0  # N
    ssm_head_dim: int = 64  # P
    ssm_expand: int = 2
    ssm_groups: int = 1  # G (B/C groups)
    ssm_conv_width: int = 4
    ssm_chunk: int = 128  # SSD chunk length
    ssm_conv_bias: bool = False  # a bias on the causal convolution's channels

    # --- positions / attention variants ---
    pos_encoding: str = "rope"  # rope | mrope | none
    rope_theta: float = 1e6
    sliding_window: int = 0  # 0 = full attention; >0 = serve-time window
    #: the attention scores' scale (None: head_dim ** -0.5)
    attention_multiplier: float | None = None
    #: scale of each mixer's and MLP's output before it joins the residual
    residual_multiplier: float = 1.0
    #: long_500k policy: "native" (SSM/hybrid), "sliding" (dense w/ window)
    long_context: str = "sliding"

    # --- modality stub (vlm / audio carve-out) ---
    modality: str = "text"  # text | vision_embeds | audio_codes
    num_codebooks: int = 0  # musicgen EnCodec codebooks

    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def padded_experts(self) -> int:
        return max(self.num_experts, self.pad_experts_to)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the embedding/LM head
        always shard over the model axis (EXPERIMENTS §Perf: an unsharded
        49155-wide head replicates full-vocab logits on every TP shard).
        Padded logit columns are masked to -inf in apply_head."""
        return -(-self.vocab_size // 128) * 128

    @property
    def experts_held(self) -> int:
        """The routed experts whose weights this chip holds."""
        return self.held_experts or self.padded_experts

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def n_periods(self) -> int:
        assert self.num_layers % len(self.period) == 0, (
            f"{self.name}: {self.num_layers} layers not divisible by period "
            f"{len(self.period)}"
        )
        return self.num_layers // len(self.period)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def smoke(self) -> "ArchConfig":
        """Reduced variant of the same family for CPU smoke tests:
        2 periods worth of layers, d_model <= 512, <= 4 experts."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4) if self.num_heads else 0
        num_kv = max(1, min(self.num_kv_heads, num_heads)) if num_heads else 0
        experts = min(self.num_experts, 4) if self.num_experts else 0
        held = min(self.held_experts, experts)
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=2 * len(self.period),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=d_model // num_heads if num_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=experts,
            pad_experts_to=0,
            held_experts=held,
            expert_offset=min(self.expert_offset, experts - held) if held else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            shared_d_ff=min(self.shared_d_ff, 128) if self.shared_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            num_codebooks=self.num_codebooks,
        )

    def flops_per_token(self) -> float:
        """Active-parameter forward FLOPs per token ~ 2 * N_active."""
        return 2.0 * self.active_params()

    # -- parameter accounting (for roofline MODEL_FLOPS = 6 N D) ----------
    def _per_layer_params(self, sub: SubLayer, active: bool) -> float:
        d, hd = self.d_model, self.resolved_head_dim
        total = 0.0
        if sub.mixer == "attn":
            total += d * (self.num_heads * hd)  # Q
            total += 2 * d * (self.num_kv_heads * hd)  # K, V
            total += (self.num_heads * hd) * d  # O
        else:
            inner, h, g, n = self.ssm_inner, self.ssm_heads, self.ssm_groups, self.ssm_state
            total += d * 2 * inner  # z, x projections
            total += d * 2 * g * n + d * h  # B, C, dt
            total += inner * d  # out proj
            total += self.ssm_conv_width * inner + 2 * h + inner  # conv, A/D, norm
            if self.ssm_conv_bias:
                total += inner + 2 * g * n
        if sub.mlp == "mlp":
            total += 3 * d * self.d_ff
        elif sub.mlp == "moe":
            e = self.top_k if active else (self.held_experts or self.num_experts)
            total += 3 * d * self.moe_d_ff * e
            total += d * self.num_experts  # router
            if self.num_shared_experts:
                total += 3 * d * self.shared_d_ff * self.num_shared_experts
        total += 2 * d  # norms
        return total

    def _params(self, active: bool) -> float:
        per_period = sum(self._per_layer_params(s, active) for s in self.period)
        total = per_period * self.n_periods
        total += 2 * self.vocab_size * self.d_model * max(1, self.num_codebooks or 1)
        total += self.d_model  # final norm
        return total

    def total_params(self) -> float:
        return self._params(active=False)

    def active_params(self) -> float:
        return self._params(active=True)


_REGISTRY: dict[str, str] = {
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1p5_large",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "falcon-demo-100m": "repro_torch.configs.falcon_demo_100m",
    "granite-4.0-h-small": "repro_torch.configs.granite_4_0_h_small",
}


def list_archs() -> list[str]:
    return list(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[name]).CONFIG
