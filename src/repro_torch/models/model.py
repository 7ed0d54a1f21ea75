"""Top-level language model — the twin of :mod:`repro.models.model`:
embed -> blocks -> head, plus loss and decode.

Input conventions per modality (the VLM/audio carve-out):
  * text:          batch["tokens"] (B, S) integer
  * vision_embeds: batch["embeds"] (B, S, D) + batch["positions"] (3, B, S)
  * audio_codes:   batch["tokens"] (B, S, K) integer (K EnCodec codebooks)
Training batches additionally carry batch["labels"] (same layout as tokens).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.models.schema import Schema, axes_tree, init_tree, shape_tree

AUX_LOSS_COEF = 0.01


def model_schema(cfg: ArchConfig) -> Schema:
    return {
        "embed": layers.embed_schema(cfg),
        "blocks": transformer.blocks_schema(cfg),
        "final_norm": layers.rmsnorm_schema(cfg.d_model),
        "head": layers.head_schema(cfg),
    }


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed`` on ``device`` (None = the card,
    raising when there is none). Deterministic per leaf, but not the JAX
    package's numbers: see :mod:`repro_torch.models.schema`."""
    return init_tree(model_schema(cfg), seed, resolve_device(device))


def param_shapes(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors (shape and type, no storage): the
    counterpart of the reference's ``ShapeDtypeStruct`` tree."""
    def meta(tree):
        return {k: meta(v) if isinstance(v, dict)
                else torch.empty(v[0], dtype=v[1], device="meta")
                for k, v in tree.items()}

    return meta(shape_tree(model_schema(cfg)))


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every parameter (``"model"`` or None per dim)."""
    return axes_tree(model_schema(cfg))


def _embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.modality == "vision_embeds":
        return batch["embeds"].to(cfg.activation_dtype)
    return layers.apply_embed(params["embed"], batch["tokens"], cfg)


def _positions(batch: dict, cfg: ArchConfig, seq_len: int) -> torch.Tensor | None:
    if cfg.pos_encoding == "none":
        return None
    if cfg.pos_encoding == "mrope":
        return batch["positions"]
    ref = batch["embeds"] if cfg.modality == "vision_embeds" else batch["tokens"]
    pos = torch.arange(seq_len, device=ref.device)[None, :]
    return pos.expand(ref.shape[0], seq_len)


def forward(
    params: dict,
    batch: dict,
    cfg: ArchConfig,
    *,
    window: int = 0,
    use_kernel: bool = False,
    remat: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass. Returns (logits, aux_loss)."""
    x = _embed_inputs(params, batch, cfg)
    positions = _positions(batch, cfg, x.shape[1])
    x, aux = transformer.apply_blocks(
        params["blocks"], x, cfg, positions,
        window=window, use_kernel=use_kernel, remat=remat,
    )
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return layers.apply_head(params["head"], x, cfg), aux


def loss_fn(
    params: dict,
    batch: dict,
    cfg: ArchConfig,
    *,
    window: int = 0,
    use_kernel: bool = False,
    remat: bool = True,
) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy (+ MoE aux). Returns (loss, metrics)."""
    logits, aux = forward(
        params, batch, cfg, window=window, use_kernel=use_kernel, remat=remat
    )
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, batch["labels"][..., None].long())[..., 0]
    ce = torch.mean(logz - ll)
    loss = ce + AUX_LOSS_COEF * aux
    return loss, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------- decode
def decode_step(
    params: dict,
    tokens: torch.Tensor,
    caches: dict,
    pos: int,
    cfg: ArchConfig,
    *,
    window: int = 0,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Generate logits for ONE new token given the cache state.

    tokens: (B, 1) integer (or (B, 1, K) audio / (B, 1, D) vision embeds);
    pos: the position, a host int. Returns (logits (B, 1, V[, K]), caches),
    the caches updated in place.
    """
    if cfg.modality == "vision_embeds":
        x = tokens.to(cfg.activation_dtype)  # already embeddings
    else:
        x = layers.apply_embed(params["embed"], tokens, cfg)
    x, caches = transformer.decode_blocks(
        params["blocks"], x, caches, pos, cfg, window=window,
        use_kernel=use_kernel,
    )
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return layers.apply_head(params["head"], x, cfg), caches
