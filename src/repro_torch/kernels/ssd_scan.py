"""SSD scan — the port of :mod:`repro.kernels.ssd_scan`: the Mamba2
state-space-duality scan, chunked, with the state carried across chunks.

:func:`ssd_scan` launches the hand-written CUDA kernel ``csrc/ssd_scan.cu``
for tensors on the card; :func:`ssd_scan_reference` is the same function in
plain PyTorch (the sequential recurrence of ``ref.ssd_ref``), which
:func:`ssd_scan` runs for tensors on the CPU.

What bounds the kernel on the H100: bytes and operations are close (~88 MB
and ~27 GFLOP, each ~26 us, for the 4,096-token forward of mamba2-2.7b's
80 heads). In bfloat16 one call runs three kernels on the tensor cores
(float32 accumulators), chunk-parallel where the chunks are independent:
(a) each chunk's own state, (b) the state passed from chunk to chunk in
float32 registers, (c) each chunk's outputs with C Bᵀ computed once per
(chunk, B/C group); (a) and (c) run ``wgmma`` fed by TMA. The operands that need
float32 precision go in as bf16 hi + lo pairs. Between the kernels each
chunk's state goes through scratch tensors the wrapper allocates (float32,
then bf16 hi and lo planes), so the design moves ~466 MB at that shape
(~0.14 ms at 3.35 TB/s, its own floor). float32 keeps one kernel on the
CUDA cores: its job is the float32 parity checks, which TF32 tensor cores
would miss. :attr:`ssd_scan.launches` counts calls, not the kernels a bf16
call runs.

Neither version has a gradient, as the JAX package's kernel has none: the
wrapper raises for inputs that require grad while grad mode is on, on
either device. Training takes the plain chunked scan of
:func:`repro_torch.models.ssm.ssd_scan`, as the JAX trainer does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref

#: the largest chunk and state size the kernel's shared memory holds
MAX_CHUNK = 128
MAX_STATE = 128

_p, _i = ctypes.c_void_p, ctypes.c_int
#: C symbol and signature per dtype: the bf16 entry also takes its two
#: scratch tensors (each chunk's state, and cum)
_ENTRY = {
    torch.float32: ("ssd_scan_f32", [_p] * 7 + [_i] * 7 + [_p, _p]),
    torch.bfloat16: ("ssd_scan_bf16", [_p, _p, _i] + [_p] * 8 + [_i] * 7 + [_p, _p]),
}

#: the plain PyTorch version: the sequential float32 recurrence of
#: ``ref.ssd_ref``, results in x's type
ssd_scan_reference = ssd_ref


def _check(name: str, t: torch.Tensor, x: torch.Tensor, shape: tuple) -> None:
    if t.device != x.device:
        raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {x.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, expected {shape}")


def ssd_scan(x, dt, a, b_mat, c_mat, *, chunk: int = 128):
    """SSD scan: the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU. x (B, S, H, P), dt (B, S, H), a (H,), b_mat and
    c_mat (B, S, G, N) -> (y (B, S, H, P), final state (B, H, P, N)) in x's
    type. S must be a multiple of ``chunk``. x, b_mat and c_mat are read
    through their strides (the last dimension contiguous); a is taken as
    float32, dt as float32 (an exact cast from bf16) or, in a bf16 call, as
    given in bf16."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, a, b_mat, c_mat)
    ):
        raise RuntimeError(
            "ssd_scan has no gradient (nor has the JAX package's kernel): "
            "call it under torch.no_grad(), or train through the plain "
            "chunked scan (use_kernel=False)"
        )
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x has shape {tuple(x.shape)}, expected 4 dims")
    bsz, s, h, p = x.shape
    if b_mat.dim() != 4:
        raise ValueError(f"ssd_scan: b_mat has shape {tuple(b_mat.shape)}, expected 4 dims")
    g, n = b_mat.shape[2], b_mat.shape[3]
    chunk = int(chunk)
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan: seq {s} % chunk {chunk} != 0")
    if g < 1 or h % g:
        raise ValueError(f"ssd_scan: {h} heads are not a multiple of {g} groups")
    _check("dt", dt, x, (bsz, s, h))
    _check("a", a, x, (h,))
    _check("b_mat", b_mat, x, (bsz, s, g, n))
    _check("c_mat", c_mat, x, (bsz, s, g, n))
    if x.device.type == "cpu":
        return ssd_scan_reference(x, dt, a, b_mat, c_mat)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"ssd_scan: dtype {x.dtype} is not float32/bfloat16")
    for name, t in (("b_mat", b_mat), ("c_mat", c_mat)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan: {name} has dtype {t.dtype}, x {x.dtype}")
    for name, t in (("x", x), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.stride(3) != 1:
            raise ValueError(f"ssd_scan: {name}'s last dimension must be contiguous")
    if chunk > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {chunk} / state {n} above the kernel's "
                         f"{MAX_CHUNK} / {MAX_STATE}")
    strided = (x.stride(0), x.stride(1), x.stride(2),
               b_mat.stride(0), b_mat.stride(1), b_mat.stride(2),
               c_mat.stride(0), c_mat.stride(1), c_mat.stride(2))
    if x.dtype == torch.bfloat16:
        # The tensor-core kernels copy 16 bytes (8 values) at a time.
        if p % 8 or n % 8:
            raise ValueError(f"ssd_scan: bf16 needs P ({p}) and N ({n}) multiples of 8")
        if any(t.data_ptr() % 16 for t in (x, b_mat, c_mat)) or any(v % 8 for v in strided):
            raise ValueError("ssd_scan: bf16 x, b_mat and c_mat must be 16-byte aligned, "
                             "with strides that are multiples of 8")
    # Casts and copies only where needed: a bf16 call from the model
    # launches the library's kernels and nothing else.
    a32 = a.to(torch.float32).contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        # The kernels read dt in bf16 or float32.
        if dt.dtype != torch.bfloat16:
            dt = dt.to(torch.float32)
        dt = dt.contiguous()
        nc = s // chunk
        delta = torch.empty((bsz, h, nc, p, n), dtype=torch.float32, device=x.device)
        planes = torch.empty((bsz, h, nc, 2, p, n), dtype=x.dtype, device=x.device)
        cum = torch.empty((bsz, h, nc, 2, chunk), dtype=torch.float32, device=x.device)
        head = [x.data_ptr(), dt.data_ptr(), int(dt.dtype == torch.bfloat16)]
        scratch = [delta.data_ptr(), planes.data_ptr(), cum.data_ptr()]
    else:
        dt = dt.to(torch.float32).contiguous()
        head, scratch = [x.data_ptr(), dt.data_ptr()], []
    strides = (ctypes.c_longlong * 9)(*strided)
    fn = _build.entry("ssd_scan", *_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            *head, a32.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
            state.data_ptr(), *scratch,
            bsz, s, h, p, g, n, chunk, ctypes.cast(strides, ctypes.c_void_p), stream,
        )
    _build.check("ssd_scan", err)
    ssd_scan.launches += 1
    return y, state


#: calls of :func:`ssd_scan` that launched the kernels (one per call, bf16
#: or float32; CPU calls not counted)
ssd_scan.launches = 0
