"""The training token stream, a frozen copy of the port's synthetic
pipeline (``src/repro_torch/data/pipeline.py``: ``_tokens`` and the text
branch of ``make_batch``), so that the reference rebuilds every batch the
trainer was fed from the same seed without calling the port."""
from __future__ import annotations

import numpy as np


def tokens(rng: np.random.Generator, shape: tuple[int, ...], vocab: int) -> np.ndarray:
    """A lazy random walk over the vocabulary: each position repeats the
    previous token with probability 0.5."""
    flat = rng.integers(0, vocab, size=shape)
    rep = rng.random(shape) < 0.5
    out = flat.copy()
    for t in range(1, shape[-1]):
        out[..., t] = np.where(rep[..., t], out[..., t - 1], out[..., t])
    return out.astype(np.int32)


def text_batch(seed: int, step: int, slots: int, rows: int, seq_len: int,
               vocab: int) -> dict:
    """``{"tokens", "labels"}``, each (slots, rows, seq_len): the batch of
    one step with data seed ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = tokens(rng, (slots, rows, seq_len + 1), vocab)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
