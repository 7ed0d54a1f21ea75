"""Device policy of the port: the card by default, the CPU only on request.

Every entry point that takes a ``device`` resolves it here. ``None`` means
the CUDA card; without one that is an error naming ``device="cpu"``, never a
silent fall back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA card, or a RuntimeError when there is
    none; anything else -> ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or a CPU "
            "backend name) to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
