"""Serving example: batched prefill + autoregressive decode with KV caches —
the PyTorch port's twin of ``examples/serve_decode.py``.

Runs two reduced architectures through the real serve path:

  * granite-3-8b (smoke)  — GQA attention with a KV cache,
  * mamba2-2.7b (smoke)   — attention-free; the "cache" is the SSM state,
    so per-token cost is O(1) in context length.

Prefill and decode take the plain routes (blocked attention, chunked SSD,
the einsum cache read), as in the reference, on ``--device``. Weights
are the port's random ones from the seed; ``serve`` also takes a parameter
tree (e.g. the reference's, carried over with
``repro_torch.convert.params_from_numpy``).

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib, transformer
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

BATCH, PROMPT, NEW_TOKENS = 4, 32, 8


@torch.no_grad()
def serve(arch: str, seed: int = 0, *, device=None, cfg=None, params=None) -> np.ndarray:
    """Prefill a random prompt and decode NEW_TOKENS greedily; returns the
    (BATCH, NEW_TOKENS) generated tokens. ``cfg`` defaults to the smoke
    config of ``arch``, ``params`` to the port's init from ``seed``."""
    device = resolve_device(device)
    cfg = cfg or get_config(arch).smoke()
    if params is None:
        params = model_lib.init_params(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(BATCH, PROMPT)), dtype=torch.int32,
        device=device,
    )
    if cfg.modality == "audio_codes":
        prompt = prompt[..., None].repeat_interleave(cfg.num_codebooks, -1)

    # 1) prefill the caches over the prompt.
    logits, caches = make_prefill_step(cfg, PROMPT)(params, {"tokens": prompt})

    # Prefill returns period-stacked caches; decode consumes the same layout
    # but padded to the serving context length.
    total = PROMPT + NEW_TOKENS
    caches = transformer.grow_caches(caches, cfg, total)

    # 2) decode NEW_TOKENS greedily, one token per step.
    decode = make_decode_step(cfg, total)
    tok = torch.argmax(logits[:, -1], dim=-1).reshape(BATCH, 1).to(torch.int32)
    if cfg.modality == "audio_codes" and tok.ndim == 2:
        tok = tok[..., None].repeat_interleave(cfg.num_codebooks, -1)
    out = []
    pos = PROMPT
    for _ in range(NEW_TOKENS):
        logits, caches = decode(params, tok, caches, pos)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        if cfg.modality == "audio_codes":
            tok = nxt.reshape(BATCH, 1, cfg.num_codebooks).to(torch.int32)
            out.append(nxt[..., 0].cpu().numpy())
        else:
            tok = nxt.reshape(BATCH, 1).to(torch.int32)
            out.append(nxt.cpu().numpy())
        pos += 1
    gen = np.stack(out, axis=1)
    assert gen.shape[:2] == (BATCH, NEW_TOKENS)
    assert bool(torch.isfinite(logits.float()).all())
    print(f"{arch:>22}: generated {gen.shape} tokens, "
          f"sample row: {gen[0].tolist()}")
    return gen


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    for arch in ("granite-3-8b", "mamba2-2.7b"):
        serve(arch, device=device)
    print("serve_decode OK")


if __name__ == "__main__":
    main()
