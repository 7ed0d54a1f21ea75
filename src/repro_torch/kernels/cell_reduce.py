"""Simulator reduction tree — the port of :mod:`repro.kernels.cell_reduce`.

:class:`repro_torch.cluster.simulator.TrainingSimulator` turns its measured
per-cell arrays (cell speed minima, ring edge and hop bandwidths) into an
iteration time with TP ring minima, the stage-time formula, per-DP-group
stage maxima, DP ring minima, the activation-hop sum, the pipeline maximum
and the DP all-reduce bottleneck. :func:`cell_reduce` does all of it in one
launch of the hand-written CUDA kernel ``csrc/cell_reduce.cu`` for tensors
on the card; :func:`cell_reduce_reference` is the same math in plain
PyTorch, which :func:`cell_reduce` runs for tensors on the CPU.

Both take the full hybrid shape (tp, dp, pp >= 1); the simulator's
``CudaReduction`` keeps the reference's numpy path when an axis is 1.
"""
from __future__ import annotations

import ctypes

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
#: C signature of ``cell_reduce_f32`` / ``cell_reduce_f64``
_ARGTYPES = [_p] * 5 + [_i] * 3 + [_d] * 5 + [_p] * 5 + [_p]
_SYMBOL = {torch.float32: "cell_reduce_f32", torch.float64: "cell_reduce_f64"}


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
    _check("cell_speed", cell_speed, (pp, dp), dt, dev)
    _check("tp_edge", tp_edge, (pp, dp, tp), dt, dev)
    _check("dp_edge", dp_edge, (pp, dp, tp), dt, dev)
    _check("hop_bw", hop_bw, (pp - 1, dp), dt, dev)
    _check("alloc_off", alloc_off, (dp,), dt, dev)
    fn = _build.entry("cell_reduce", _SYMBOL[dt], _ARGTYPES)
    t =torch.empty((1, 1), dtype=dt, device=dev)
    stage_max = torch.empty((1, dp), dtype=dt, device=dev)
    tp_bw = torch.empty((pp, dp), dtype=dt, device=dev)
    dp_bw = torch.empty((pp, tp), dtype=dt, device=dev)
    stage = torch.empty((pp, dp), dtype=dt, device=dev)   # scratch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            cell_speed.data_ptr(), tp_edge.data_ptr(), dp_edge.data_ptr(),
            hop_bw.data_ptr(), alloc_off.data_ptr(), pp, dp, tp,
            float(c_flops), float(c_speed), float(c_tp), float(pp_vol),
            float(c_dp), t.data_ptr(), stage_max.data_ptr(), tp_bw.data_ptr(),
            dp_bw.data_ptr(), stage.data_ptr(), stream,
        )
    _build.check("cell_reduce", err)
    cell_reduce.launches += 1
    return t, stage_max, tp_bw, dp_bw


#: kernel launches made through :func:`cell_reduce` (CPU calls not counted)
cell_reduce.launches = 0
