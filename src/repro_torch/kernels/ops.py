"""Public wrappers of the attention kernels — the twin of
:mod:`repro.kernels.ops`, under the reference's names.

The reference's TPU tiling arguments are dropped: ``block_q``/``block_k``
sized Pallas blocks for the TPU's VMEM and 128 x 128 matrix unit, and
``interpret`` ran the Pallas program in Python on the CPU. Here each CUDA
kernel fixes its own tiling (64 x 64 tiles for attention; about 128 cache
positions per split for decode), and a tensor on the CPU takes the kernel's
plain PyTorch version. ``ssd_scan`` comes with the training slice.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd


def flash_attention(q, k, v, *, causal=True, window=0):
    """q (B, Sq, H, hd), k/v (B, Skv, KVH, hd) -> (B, Sq, H, hd)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def flash_decode(q, k, v, valid_len):
    """q (B, H, hd), k/v (B, Skv, KVH, hd), ``valid_len`` an int or (B,)
    tensor -> (B, H, hd)."""
    return _fd.flash_decode(q, k, v, valid_len)
