"""Deterministic synthetic token pipeline — the twin of
:mod:`repro.data.pipeline`, carried over unchanged (numpy on the host):
the port's batches are bit-identical to the JAX package's.

Produces per-step batches in the framework's slot layout
``(slots, global_microbatch, S, ...)``: slot ``m`` column ``i`` holds the
m-th micro-batch assigned to DP group ``i``. With FALCON S2 active, groups
process only their first ``m_i`` slots (dynamic trip counts), so the loader
simply keeps every slot filled. Data is a fixed-seed PRNG stream — bitwise
deterministic across restarts (checkpoint resume replays the same batches)
and host-shardable by (step, slot, group).

The token stream is a structured integer process (random walk over the
vocab with local repetition) rather than iid noise, so cross-entropy
actually *decreases* during the example runs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int  # sequences per iteration
    slots: int = 8  # micro-batch slots per DP group
    dp_groups: int = 1
    seed: int = 1234

    @property
    def mb_sequences(self) -> int:
        """Sequences per micro-batch per DP group."""
        per_group = self.global_batch // self.dp_groups
        assert per_group % self.slots == 0 or per_group >= self.slots, (
            f"global batch {self.global_batch} too small for "
            f"{self.dp_groups} groups x {self.slots} slots"
        )
        return max(1, per_group // self.slots)


def _tokens(rng: np.random.Generator, shape: tuple[int, ...], vocab: int) -> np.ndarray:
    """Structured stream: a lazy random walk with repetition."""
    flat = rng.integers(0, vocab, size=shape)
    # Repeat the previous token with p=0.5 along the last axis -> learnable.
    rep = rng.random(shape) < 0.5
    out = flat.copy()
    for t in range(1, shape[-1]):
        out[..., t] = np.where(rep[..., t], out[..., t - 1], out[..., t])
    return out.astype(np.int32)


def make_batch(cfg: ArchConfig, data: DataConfig, step: int) -> dict:
    """Training batch for one step (numpy, host-side)."""
    rng = np.random.default_rng(np.random.SeedSequence([data.seed, step]))
    slots = data.slots
    gmb = data.dp_groups * data.mb_sequences  # sequences per slot row
    s = data.seq_len
    if cfg.modality == "vision_embeds":
        embeds = rng.normal(0, 1, size=(slots, gmb, s, cfg.d_model)).astype(np.float32)
        labels = _tokens(rng, (slots, gmb, s), cfg.vocab_size)
        positions = np.broadcast_to(np.arange(s, dtype=np.int32), (3, gmb, s)).copy()
        return {"embeds": embeds, "positions": positions, "labels": labels}
    if cfg.modality == "audio_codes":
        k = cfg.num_codebooks
        toks = _tokens(rng, (slots, gmb, s * k), cfg.vocab_size).reshape(slots, gmb, s, k)
        labels = np.roll(toks, -1, axis=2)
        return {"tokens": toks, "labels": labels}
    toks = _tokens(rng, (slots, gmb, s + 1), cfg.vocab_size)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
