"""Flash attention — the port of :mod:`repro.kernels.flash_attention`:
blocked online-softmax attention with GQA, causal and sliding-window masks.

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` for tensors on the card;
:func:`flash_attention_reference` is the same function in plain PyTorch
(the materialized math of ``ref.attention_ref``), which
:func:`flash_attention` runs for tensors on the CPU.

What bounds the kernel on the H100: operations (~137.5 GFLOP, ~0.139 ms
at the bf16 tensor-core peak, for the 4,096-token forward of
granite-3-8b's 32/8 heads). In bf16 the kernel runs both products on the
tensor cores (``wgmma``, float32 accumulation, P rounded to bf16 before
P·V) with K/V tiles brought in by TMA; its inputs must start and have their
row strides on 16-byte boundaries. float32 stays on the CUDA cores in full
float32. The ragged Sq/Skv edges are masked inside the kernel, so no padded
copies are made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128)

_SYMBOL = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_p] * 4 + [_i] * 6 + [_p, _f, _i, _i, _p]


#: the plain PyTorch version: the materialized float32 softmax of
#: ``ref.attention_ref``, masks included, the result in q's type
flash_attention_reference = attention_ref


def _check(name: str, t: torch.Tensor, q: torch.Tensor, b: int, hd: int):
    if t.device != q.device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
    if t.dtype != q.dtype:
        raise ValueError(f"flash_attention: {name} has dtype {t.dtype}, q {q.dtype}")
    if t.dim() != 4 or t.shape[0] != b or t.shape[3] != hd:
        raise ValueError(f"flash_attention: {name} has shape {tuple(t.shape)}, "
                         f"expected ({b}, S, heads, {hd})")
    if t.stride(3) != 1:
        raise ValueError(f"flash_attention: {name}'s last dimension must be contiguous")
    if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
        raise ValueError(f"flash_attention: {name} must start and have its row strides on "
                         "16-byte boundaries (the bf16 kernel copies 16 bytes at a time)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flash attention: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU (same arguments and result as
    :func:`flash_attention_reference`). Inputs are read through their
    strides (the last dimension contiguous); the output is a contiguous
    (B, Sq, H, hd) tensor in q's type."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _SYMBOL:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32/bfloat16")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q has shape {tuple(q.shape)}, expected 4 dims")
    b, sq, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    _check("q", q, q, b, hd)
    _check("k", k, q, b, hd)
    _check("v", v, q, b, hd)
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: v has shape {tuple(v.shape)}, k {tuple(k.shape)}")
    skv, kvh = k.shape[1], k.shape[2]
    if kvh < 1 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads are not a multiple of "
                         f"{kvh} KV heads")
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
    )
    fn = _build.entry("flash_attention", _SYMBOL[q.dtype], _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, h, kvh, hd, ctypes.cast(strides, ctypes.c_void_p),
            float(hd**-0.5), int(bool(causal)), window, stream,
        )
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


#: kernel launches made through :func:`flash_attention` (CPU calls not counted)
flash_attention.launches = 0
