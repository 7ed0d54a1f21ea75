"""Flash decode — the port of :mod:`repro.kernels.flash_decode`: one query
token per sequence against a (B, Skv, KVH, hd) KV cache.

:func:`flash_decode` launches the hand-written CUDA kernel
``csrc/flash_decode.cu`` for tensors on the card: one launch, split-K over
the cache with the splits of one (sequence, KV head) forming a thread-block
cluster whose log-sum-exp combine runs in distributed shared memory, so no
partials go to device memory. :func:`flash_decode_reference` is the same
function in plain PyTorch, which :func:`flash_decode` runs for tensors on
the CPU.

Both follow the Pallas kernel at ``valid_len = 0``: the row is zeros (its
``acc / max(l, 1e-30)`` with nothing accumulated), where the materialized
oracle ``ref.decode_attention_ref`` gives the uniform mean of V.

What bounds the kernel on the H100: the bytes of the valid K/V prefix,
read once (~35.8 MB, ~10.7 us, at the serve shape B = 8, KVH = 8, hd =
128, ~1,088 positions in bf16). The cache is read through its strides —
no transposed or padded copy per call, unlike the Pallas wrapper — in
16-byte copies (every pointer and row stride 16-byte aligned), and no split
reads past ``valid_len``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, valid_lengths

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
#: cache positions per split (the split count is about valid_len / this,
#: at most MAX_SPLITS), so that B * KVH clusters of blocks fill the card's
#: 132 SMs
KEYS_PER_SPLIT = 128
#: the splits of one (sequence, KV head) form one thread-block cluster: at
#: most the portable cluster size
MAX_SPLITS = 8

_SYMBOL = {torch.float32: "flash_decode_f32", torch.bfloat16: "flash_decode_bf16"}
_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_p] * 4 + [_i] * 8 + [_ll] * 6 + [_f] + [_p] * 2


def flash_decode_reference(q, k, v, valid_len) -> torch.Tensor:
    """Plain PyTorch flash decode: q (B, H, hd), k/v (B, Skv, KVH, hd),
    ``valid_len`` an int, a 0-d or a (B,) tensor; positions ``< valid_len``
    attend. The math of ``ref.decode_attention_ref`` (float32 scores,
    softmax and sum, the result in q's type), with GQA by grouping the query
    heads of a KV head instead of repeating K/V, and zeros where
    ``valid_len`` is 0."""
    b, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qg = q.float().reshape(b, kvh, rep, hd) * hd**-0.5
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k.float())
    lens = valid_lengths(valid_len, b, q.device)
    mask = torch.arange(skv, device=q.device)[None, :] < lens[:, None]  # (B, Skv)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, v.float()).reshape(b, h, hd)
    out = out.masked_fill((lens <= 0)[:, None, None], 0.0)
    return out.to(q.dtype)


def num_splits(max_len: int) -> int:
    """Splits of the cache per (sequence, KV head) for ``max_len`` valid
    positions at most: about one per KEYS_PER_SPLIT, at most MAX_SPLITS."""
    return max(1, min(MAX_SPLITS, -(-max_len // KEYS_PER_SPLIT)))


def split_chunk(length: int, n_split: int) -> int:
    """Cache positions a split reads for ``length`` valid ones:
    ceil(length / n_split)."""
    return -(-length // n_split)


def _check_cache(name: str, t: torch.Tensor, q: torch.Tensor, b: int, kvh: int, hd: int):
    if t.device != q.device:
        raise ValueError(f"flash_decode: {name} is on {t.device}, q on {q.device}")
    if t.dtype != q.dtype:
        raise ValueError(f"flash_decode: {name} has dtype {t.dtype}, q {q.dtype}")
    if t.dim() != 4 or t.shape[0] != b or t.shape[2] != kvh or t.shape[3] != hd:
        raise ValueError(f"flash_decode: {name} has shape {tuple(t.shape)}, "
                         f"expected ({b}, Skv, {kvh}, {hd})")
    if t.stride(3) != 1:
        raise ValueError(f"flash_decode: {name}'s last dimension must be contiguous")
    _check_aligned(name, t)


def _check_aligned(name: str, t: torch.Tensor):
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:-1]):
        raise ValueError(f"flash_decode: {name} must start and have its row strides on "
                         "16-byte boundaries (the kernel copies 16 bytes at a time)")


def flash_decode(q, k, v, valid_len) -> torch.Tensor:
    """Flash decode: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU (same arguments and result as
    :func:`flash_decode_reference`).

    ``valid_len`` as a Python int is passed by value; as a (B,) int32
    tensor on the card, the kernel reads it there (no host
    synchronisation), and the split count is then sized for the whole
    cache. Values are clamped to ``[0, Skv]``. One kernel launch per call;
    q and the cache rows must be 16-byte aligned."""
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dtype not in _SYMBOL:
        raise ValueError(f"flash_decode: dtype {q.dtype} is not float32/bfloat16")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError("flash_decode: q must be a contiguous (B, H, hd) tensor")
    b, h, hd = q.shape
    if k.dim() != 4:
        raise ValueError(f"flash_decode: k has shape {tuple(k.shape)}, expected 4 dims")
    skv, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {hd} not in {HEAD_DIMS}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"flash_decode: {h} query heads are not a multiple of {kvh} KV heads")
    _check_aligned("q", q)
    _check_cache("k", k, q, b, kvh, hd)
    _check_cache("v", v, q, b, kvh, hd)
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_decode: v has shape {tuple(v.shape)}, k {tuple(k.shape)}")
    if isinstance(valid_len, torch.Tensor):
        lens = valid_lengths(valid_len, b, q.device).contiguous()
        n_split = num_splits(skv)
        lens_ptr, len_scalar, chunk = lens.data_ptr(), 0, 0
    else:
        lens, lens_ptr, len_scalar = None, None, int(valid_len)
        length = max(0, min(len_scalar, skv))
        n_split = num_splits(length)
        chunk = split_chunk(length, n_split)
    dev = q.device
    out = torch.empty_like(q)
    fn = _build.entry("flash_decode", _SYMBOL[q.dtype], _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_ptr, len_scalar, chunk,
            b, h, kvh, hd, skv, n_split,
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(hd**-0.5), out.data_ptr(), stream,
        )
    _build.check("flash_decode", err)
    flash_decode.launches += 1
    return out


#: kernel launches made through :func:`flash_decode` (CPU calls not counted)
flash_decode.launches = 0
