"""Per-rank (manual) computation on a DeviceMesh — what ``shard_map`` and
its collectives are to the JAX package.

Code that runs on each rank's local shards (the expert-parallel MoE, the
sharded decode, prefill and train steps, the adaptive train step) takes its
inputs through :func:`local_shard`, talks to the other ranks through this
module's collectives over named mesh axes, and hands results back with
:func:`as_dtensor` or :func:`gather`. Every collective runs on the process
group the mesh holds for that axis (``mesh.get_group(axis)``); an axis of
size 1 costs nothing. Over several axes a collective runs one axis after
another.

Plain collectives (no gradient): :func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`. Collectives that autograd passes through, each with
the backward that makes a per-rank program compute the unsharded gradient:

* :func:`enter` — identity forward, all-reduce backward: the input of a
  column-parallel layer (Megatron's *f*), whose ranks each see a part of
  the input's gradient;
* :func:`leave` — all-reduce forward, identity backward: the output of a
  row-parallel layer (Megatron's *g*);
* :func:`gather_at_use` — all-gather forward, reduce-scatter backward: an
  FSDP weight gathered where it is used, and column shards that every rank
  then uses only in part;
* :func:`gather_whole` — all-gather forward, split backward: a shard
  gathered for a computation that every rank repeats whole;
* :func:`psum` — all-reduce forward and backward (JAX's ``psum`` under
  ``shard_map``): a sum that every rank uses for its own part of the
  output, as the mean square of a norm over features split across ranks.

Floating tensors are reduced and gathered in float32 (float64 stays
float64): gloo serves that type for tensors on the card as well as on the
CPU, and float32 keeps bfloat16 sums from rounding once per rank. A
bfloat16 tensor therefore moves twice its own bytes.

:func:`record_collectives` counts what moves: inside its block every
collective of this module adds the bytes of its result, in the type it
moved (so bfloat16 counts as float32), under XLA's names ``all-reduce``,
``all-gather`` and ``reduce-scatter`` (a collective over several axes is
counted once, by its final result; a backward collective is counted when
autograd runs it). The record is kept per process, not per thread: the
autograd engine runs backward collectives on its own threads.
"""
from __future__ import annotations

import contextlib
import threading
import warnings

import torch
import torch.distributed as dist

from repro_torch.sharding import P
from repro_torch.sharding.partition import (
    axis_sizes, coordinate, placements, shard_slices, spec_axes,
)

_RECORDS: list[dict] = []
_RECORD_LOCK = threading.Lock()


@contextlib.contextmanager
def record_collectives():
    """Yields a dict ``{XLA collective name: bytes}`` that every collective
    of this module adds its result's bytes to until the block ends."""
    rec: dict[str, float] = {}
    with _RECORD_LOCK:
        _RECORDS.append(rec)
    try:
        yield rec
    finally:
        with _RECORD_LOCK:
            _RECORDS.remove(rec)


def _record(kind: str, t: torch.Tensor) -> None:
    with _RECORD_LOCK:
        for rec in _RECORDS:
            rec[kind] = rec.get(kind, 0.0) + float(t.numel() * t.element_size())


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_shard(t, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec``: a DTensor's local tensor
    (its placements must be ``spec``'s, or ValueError), or the slice of a
    plain tensor, which is taken as the same full value on every rank (a
    view: no copy)."""
    if is_dtensor(t):
        want = placements(spec, mesh)
        if tuple(t.placements) != want:
            raise ValueError(f"a DTensor placed {tuple(t.placements)}, expected {want} "
                             f"(spec {spec})")
        return t.to_local()
    return t[shard_slices(t.shape, spec, axis_sizes(mesh), coordinate(mesh))]


def as_dtensor(local: torch.Tensor, spec: P, mesh, shape=None):
    """The DTensor whose shard on this rank is ``local`` under ``spec``."""
    from torch.distributed.tensor import DTensor

    kw = {} if shape is None else {"shape": torch.Size(shape),
                                   "stride": torch.empty(shape, device="meta").stride()}
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False, **kw)


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` flattened, the first the most major."""
    sizes, coord = axis_sizes(mesh), coordinate(mesh)
    idx = 0
    for a in spec_axes(axes):
        idx = idx * sizes[a] + coord[a]
    return idx


def _live(axes, mesh) -> tuple[str, ...]:
    """The axes of ``axes`` with more than one rank."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in spec_axes(axes) if sizes[a] > 1)


def _wire_type(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.is_floating_point() and t.dtype != torch.float64 else t.dtype


# ------------------------------------------------------ plain collectives
def all_reduce(t: torch.Tensor, axes, mesh, op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over the mesh axes ``axes``
    (a name or a tuple); returns a new tensor in ``t``'s type."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = t.to(_wire_type(t), copy=True).contiguous()
    live = _live(axes, mesh)
    for a in live:
        dist.all_reduce(out, op=red, group=mesh.get_group(a))
    if live:
        _record("all-reduce", out)
    return out.to(t.dtype)


def all_gather(t: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """The shards of the mesh axes ``axes`` concatenated along ``dim``, the
    first axis the most major (the inverse of a spec entry ``axes`` on
    ``dim``)."""
    sizes = axis_sizes(mesh)
    out = t.to(_wire_type(t)).contiguous()
    live = _live(axes, mesh)
    for a in reversed(live):      # minor first: each gather concatenates blocks
        n = sizes[a]
        parts = out.new_zeros(n * out.numel())
        with warnings.catch_warnings():   # renamed in newer torch, same call
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(parts, out.reshape(-1), group=mesh.get_group(a))
        parts = parts.view(n, *out.shape)
        d = dim % out.dim()
        out = parts.movedim(0, d).reshape(*out.shape[:d], n * out.shape[d], *out.shape[d + 1:])
    if live:
        _record("all-gather", out)
    return out.to(t.dtype)


def reduce_scatter(t: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """``t`` summed over the mesh axes ``axes`` and split along ``dim`` as a
    spec entry ``axes`` splits it: this rank's block of the sum (the
    adjoint of :func:`all_gather`)."""
    sizes = axis_sizes(mesh)
    out = t.to(_wire_type(t))
    live = _live(axes, mesh)
    for a in live:                # major first: each step keeps one block
        n = sizes[a]
        src = out.movedim(dim, 0).contiguous()
        if src.shape[0] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {a!r}")
        dst = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        with warnings.catch_warnings():   # renamed in newer torch, same call
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(dst, src, group=mesh.get_group(a))
        out = dst.movedim(0, dim)
    if live:
        _record("reduce-scatter", out)
    return out.to(t.dtype)


def gather(local: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from every rank's shard under ``spec``."""
    out = local
    for d, entry in enumerate(spec):
        if entry is not None:
            out = all_gather(out, entry, mesh, d)
    return out


def split(t: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` under the spec entry
    ``axes`` (a view; no communication)."""
    n = 1
    for a in spec_axes(axes):
        n *= axis_sizes(mesh)[a]
    step = t.shape[dim] // n
    return t.narrow(dim, axis_index(mesh, axes) * step, step)


# ------------------------------------------------- autograd collectives
class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, ctx.mesh), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return all_reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return all_gather(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axes, ctx.mesh, ctx.dim), None, None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return all_gather(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return split(g, ctx.axes, ctx.mesh, ctx.dim).contiguous(), None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, ctx.mesh), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def enter(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``x`` unchanged; its gradient all-reduced over ``axes``."""
    return _Enter.apply(x, axes, mesh) if _tracked(x) and _live(axes, mesh) else x


def leave(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """:func:`all_reduce` of ``x`` (a sum) whose gradient passes unchanged."""
    return _Leave.apply(x, axes, mesh) if _tracked(x) else all_reduce(x, axes, mesh)


def gather_at_use(x: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """:func:`all_gather` whose gradient is reduce-scattered back."""
    if _tracked(x):
        return _GatherAtUse.apply(x, axes, mesh, dim)
    return all_gather(x, axes, mesh, dim)


def gather_whole(x: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """:func:`all_gather` whose gradient is this rank's block of the
    gathered tensor's gradient (every rank computed the same gradient)."""
    if _tracked(x):
        return _GatherWhole.apply(x, axes, mesh, dim)
    return all_gather(x, axes, mesh, dim)


def psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """:func:`all_reduce` of ``x`` (a sum) whose gradient is all-reduced
    too."""
    return _PSum.apply(x, axes, mesh) if _tracked(x) else all_reduce(x, axes, mesh)
