"""Simulator reduction tree — the port of :mod:`repro.kernels.cell_reduce`.

:class:`repro_torch.cluster.simulator.TrainingSimulator` turns its measured
per-cell arrays (cell speed minima, ring edge and hop bandwidths) into an
iteration time with TP ring minima, the stage-time formula, per-DP-group
stage maxima, DP ring minima, the activation-hop sum, the pipeline maximum
and the DP all-reduce bottleneck. :func:`cell_reduce` does all of it in one
launch of the hand-written CUDA kernel ``csrc/cell_reduce.cu`` for tensors
on the card; :func:`cell_reduce_reference` is the same math in plain
PyTorch, which :func:`cell_reduce` runs for tensors on the CPU.

:func:`cell_reduce_packed` is the simulator's entry to the same kernel: the
five cell arrays in one float64 buffer (:func:`packed_layout`, filled by
:func:`pack_cells`) and the four results in one output (:func:`split_out`),
so an evaluation is one upload and one download. Its float32 results round
each float64 cell on load, as ``.to(torch.float32)`` does, so they equal
:func:`cell_reduce` on float32 copies bit for bit.

Both take the full hybrid shape (tp, dp, pp >= 1); the simulator's
``CudaReduction`` keeps the reference's numpy path when an axis is 1.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

_FLOAT_TYPES = (torch.float32, torch.float64)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor in ``like``'s type and device (the reference's
    ``jnp.asarray(c, dt)``): keeps every division tensor / tensor. Filled
    on the device, so it needs no host synchronisation."""
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def cell_reduce_reference(
    cell_speed, tp_edge, dp_edge, hop_bw, alloc_off,
    c_flops, c_speed, c_tp, pp_vol, c_dp,
):
    """The reduction tree in plain PyTorch, on any device.

    Shapes: ``cell_speed`` (pp, dp); ``tp_edge``/``dp_edge`` (pp, dp, tp);
    ``hop_bw`` (pp - 1, dp); ``alloc_off`` (dp,) or (1, dp) —
    ``allocation + pp - 1``. Constants are python floats. Returns
    ``(t, stage_max, tp_bw, dp_bw)`` with ``t`` (1, 1), ``stage_max``
    (1, dp), ``tp_bw`` (pp, dp) and ``dp_bw`` (pp, tp).
    """
    pp, dp, tp = tp_edge.shape
    alloc_off = alloc_off.to(cell_speed.dtype).reshape(1, dp)
    tp_bw = torch.amin(tp_edge, dim=2)                     # TP ring minima
    stage = _scalar(c_flops, cell_speed) / (
        _scalar(c_speed, cell_speed) * cell_speed
    ) + _scalar(c_tp, cell_speed) / tp_bw
    stage_max = torch.amax(stage, dim=0, keepdim=True)     # per-DP-group
    dp_bw = torch.amin(dp_edge, dim=1)                     # DP ring minima
    # Hop sum row by row from stage 0, the reference's own order.
    vol = _scalar(pp_vol, cell_speed)
    hop = torch.zeros((1, dp), dtype=cell_speed.dtype, device=cell_speed.device)
    for s in range(pp - 1):
        hop = hop + vol / hop_bw[s:s + 1]
    pipe = alloc_off * stage_max + 2.0 * hop               # 1F1B + hops
    t = torch.amax(pipe) + _scalar(c_dp, cell_speed) / torch.amin(dp_bw)
    return t.reshape(1, 1), stage_max, tp_bw, dp_bw


def _shapes(pp: int, dp: int, tp: int):
    """Shapes of cell_speed, tp_edge, dp_edge, hop_bw and alloc_off."""
    return ((pp, dp), (pp, dp, tp), (pp, dp, tp), (pp - 1, dp), (dp,))


#: the most blocks of the kernel's cluster (kMaxBlocks in csrc/cell_reduce.cu)
MAX_BLOCKS = 8


def blocks_of(dp: int) -> tuple[int, int]:
    """The kernel's blocks of dp columns: ``(blocks, span)``, block b taking
    columns [b * span, min((b + 1) * span, dp))."""
    span = -(-dp // min(MAX_BLOCKS, dp))
    return -(-dp // span), span


@functools.cache
def packed_layout(pp: int, dp: int, tp: int) -> tuple[tuple[int, ...], int]:
    """Element offsets of cell_speed, tp_edge, dp_edge, hop_bw and
    alloc_off in the packed float64 buffer, and its length. Each array
    keeps its own shape and starts on a 16-byte boundary (padded to one)."""
    offsets, n = [], 0
    for shape in _shapes(pp, dp, tp):
        offsets.append(n)
        n += -(-int(np.prod(shape)) // 2) * 2
    return tuple(offsets), n


@functools.cache
def _slices(pp: int, dp: int, tp: int) -> tuple[slice, ...]:
    """Where each array lies in the packed buffer."""
    offsets, _ = packed_layout(pp, dp, tp)
    return tuple(slice(o, o + int(np.prod(shape)))
                 for o, shape in zip(offsets, _shapes(pp, dp, tp), strict=True))


def out_size(pp: int, dp: int, tp: int) -> int:
    """Length of the packed results: t, stage_max (dp), tp_bw (pp * dp),
    dp_bw (pp * tp)."""
    return 1 + dp + pp * dp + pp * tp


def pack_cells(buf: np.ndarray, arrays, shape) -> None:
    """Write the five float64 cell arrays into ``buf`` (1-D, the packed
    layout of ``shape`` = (pp, dp, tp)); the padding is left as it is."""
    for sl, a in zip(_slices(*shape), arrays, strict=True):
        buf[sl] = a.reshape(-1)


def unpack_cells(cells: torch.Tensor, shape):
    """Views of the five arrays in a packed buffer."""
    return tuple(cells[sl].view(want)
                 for sl, want in zip(_slices(*shape), _shapes(*shape), strict=True))


def split_out(out: torch.Tensor, shape):
    """Views ``(t, stage_max, tp_bw, dp_bw)`` of packed results, shaped as
    :func:`cell_reduce` returns them."""
    pp, dp, tp = shape
    k = 1 + dp + pp * dp
    return (out[:1].view(1, 1), out[1:1 + dp].view(1, dp),
            out[1 + dp:k].view(pp, dp), out[k:k + pp * tp].view(pp, tp))


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"cell_reduce: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"cell_reduce: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"cell_reduce: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"cell_reduce: {name} must be contiguous")


_p, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: C signature of ``cell_reduce_f32`` / ``_f64`` / ``_f64_f32``
_ARGTYPES = [_p] + [_i] * 4 + [_d] * 5 + [_p] * 4 + [_p]
#: (input type, arithmetic type) -> C entry point
_SYMBOL = {
    (torch.float32, torch.float32): "cell_reduce_f32",
    (torch.float64, torch.float64): "cell_reduce_f64",
    (torch.float64, torch.float32): "cell_reduce_f64_f32",
}


@functools.cache
def _smem(pp: int, dp: int, tp: int, acc_bytes: int, index: int) -> tuple[int, int]:
    """Shared memory a block of the kernel takes for this shape (block 0
    gathers every block's pp * tp ring minima), and the most card ``index``
    gives a block: the launch needs the first no larger."""
    with torch.cuda.device(index):
        need = _build.entry("cell_reduce", "cell_reduce_smem_bytes", [_i] * 5,
                            ctypes.c_longlong)(pp, dp, tp, blocks_of(dp)[1], acc_bytes)
        limit = _build.entry("cell_reduce", "cell_reduce_smem_limit", [])()
    if need < 0 or limit < 0:
        raise RuntimeError("cell_reduce: could not read the card's shared-memory limit")
    return need, limit


def _launch(in_dtype, dtype, dev, ins, shape, consts, outs) -> None:
    """One launch on the current stream of ``dev``: ``ins`` and ``outs``
    are data pointers of the five inputs and the four results."""
    pp, dp, tp = shape
    need, limit = _smem(pp, dp, tp, dtype.itemsize, dev.index)
    if need > limit:
        raise ValueError(
            f"cell_reduce: the ring minima of pp * tp = {pp * tp} rings from "
            f"{blocks_of(dp)[0]} blocks take {need} bytes of shared memory, above "
            f"the {limit} a block has on {dev}"
        )
    fn = _build.entry("cell_reduce", _SYMBOL[(in_dtype, dtype)], _ARGTYPES)
    args = ((_p * 5)(*ins), pp, dp, tp, blocks_of(dp)[1], *(float(c) for c in consts), *outs)
    if dev.index == torch.cuda.current_device():
        # The raw handle of the current stream: building a Stream object
        # takes host time, which a simulator evaluation feels.
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check("cell_reduce", err)
    cell_reduce.launches += 1


def cell_reduce(
    cell_speed, tp_edge, dp_edge, hop_bw, alloc_off,
    c_flops, c_speed, c_tp, pp_vol, c_dp,
):
    """The reduction tree: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU (same arguments and results as
    :func:`cell_reduce_reference`; ``alloc_off`` is cast to the state's
    type as the reference does)."""
    if cell_speed.device.type == "cpu":
        return cell_reduce_reference(
            cell_speed, tp_edge, dp_edge, hop_bw, alloc_off,
            c_flops, c_speed, c_tp, pp_vol, c_dp,
        )
    if cell_speed.device.type != "cuda":
        raise ValueError(f"cell_reduce: unsupported device {cell_speed.device}")
    dt, dev = cell_speed.dtype, cell_speed.device
    if dt not in _FLOAT_TYPES:
        raise ValueError(f"cell_reduce: dtype {dt} is not float32/float64")
    pp, dp, tp = tp_edge.shape
    alloc_off = alloc_off.to(dt).reshape(dp).contiguous()
    ins = (cell_speed, tp_edge, dp_edge, hop_bw, alloc_off)
    names = ("cell_speed", "tp_edge", "dp_edge", "hop_bw", "alloc_off")
    for name, a, shape in zip(names, ins, _shapes(pp, dp, tp), strict=True):
        _check(name, a, shape, dt, dev)
    out = torch.empty(out_size(pp, dp, tp), dtype=dt, device=dev)
    res = split_out(out, (pp, dp, tp))
    _launch(dt, dt, dev, [a.data_ptr() for a in ins], (pp, dp, tp),
            (c_flops, c_speed, c_tp, pp_vol, c_dp), [r.data_ptr() for r in res])
    return res


def cell_reduce_packed_reference(
    cells, shape, c_flops, c_speed, c_tp, pp_vol, c_dp, *, out,
):
    """:func:`cell_reduce_packed` in plain PyTorch, on any device: the
    arrays unpacked, cast to ``out``'s type and reduced by
    :func:`cell_reduce_reference`."""
    arrays = (a.to(out.dtype) for a in unpack_cells(cells, shape))
    res = cell_reduce_reference(*arrays, c_flops, c_speed, c_tp, pp_vol, c_dp)
    torch.cat([r.reshape(-1) for r in res], out=out)
    return out


def cell_reduce_packed(
    cells, shape, c_flops, c_speed, c_tp, pp_vol, c_dp, *, out,
):
    """The reduction tree on packed buffers: ``cells`` (1-D float64, the
    :func:`packed_layout` of ``shape`` = (pp, dp, tp)) in, ``out`` (1-D,
    :func:`out_size`, float32 or float64: the arithmetic type) written with
    ``t, stage_max, tp_bw, dp_bw`` (:func:`split_out`). One launch of the
    CUDA kernel for tensors on the card (each cell rounded to ``out``'s type
    on load), :func:`cell_reduce_packed_reference` for tensors on the CPU.
    Returns ``out``."""
    pp, dp, tp = shape
    if cells.device.type == "cpu":
        return cell_reduce_packed_reference(
            cells, shape, c_flops, c_speed, c_tp, pp_vol, c_dp, out=out,
        )
    if cells.device.type != "cuda":
        raise ValueError(f"cell_reduce: unsupported device {cells.device}")
    dev = cells.device
    offsets, n_in = packed_layout(pp, dp, tp)
    _check("cells", cells, (n_in,), torch.float64, dev)
    if out.dtype not in _FLOAT_TYPES:
        raise ValueError(f"cell_reduce: dtype {out.dtype} is not float32/float64")
    _check("out", out, (out_size(pp, dp, tp),), out.dtype, dev)
    base, o, size = cells.data_ptr(), out.data_ptr(), out.element_size()
    _launch(torch.float64, out.dtype, dev, [base + 8 * off for off in offsets],
            shape, (c_flops, c_speed, c_tp, pp_vol, c_dp),
            [o, o + size, o + size * (1 + dp), o + size * (1 + dp + pp * dp)])
    return out


#: kernel launches made through :func:`cell_reduce` and
#: :func:`cell_reduce_packed` (CPU calls not counted)
cell_reduce.launches = 0


def empty_launch(device) -> None:
    """Launch one empty block of the kernel's width on ``device``'s current
    stream: the floor no one-launch design can pass (for timing only)."""
    dev = torch.device(device)
    fn = _build.entry("cell_reduce", "cell_reduce_empty", [_p])
    with torch.cuda.device(dev):
        err = fn(torch.cuda.current_stream(dev).cuda_stream)
    _build.check("cell_reduce", err)
