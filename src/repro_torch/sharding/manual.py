"""Per-rank (manual) computation on a DeviceMesh — what ``shard_map`` and
its collectives are to the JAX package.

Code that runs on each rank's local shards (the expert-parallel MoE, the
sharded decode, the adaptive train step) takes its inputs through
:func:`local_shard`, talks to the other ranks through :func:`all_reduce`
and :func:`all_gather` over named mesh axes, and hands results back with
:func:`as_dtensor` or :func:`gather`. Every collective runs on the process
group the mesh holds for that axis (``mesh.get_group(axis)``); an axis of
size 1 costs nothing.

Only ``all_reduce`` and ``all_gather`` are used, in float32 for floating
types: they are what the gloo backend serves for tensors on the card as
well as on the CPU, and float32 keeps bfloat16 sums from rounding once per
rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding import P
from repro_torch.sharding.partition import (
    axis_sizes, coordinate, placements, shard_slices, spec_axes,
)


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


def _reduce_type(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.is_floating_point() and t.dtype != torch.float64 else t.dtype


def all_reduce(t: torch.Tensor, axes, mesh, op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over the mesh axes ``axes``
    (a name or a tuple), one axis after another; returns a new tensor in
    ``t``'s type."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    sizes = axis_sizes(mesh)
    out = t.to(_reduce_type(t), copy=True).contiguous()
    for a in spec_axes(axes):
        if sizes[a] > 1:
            dist.all_reduce(out, op=red, group=mesh.get_group(a))
    return out.to(t.dtype)


def all_gather(t: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """The shards of the mesh axes ``axes`` concatenated along ``dim``, the
    first axis the most major (the inverse of a spec entry ``axes`` on
    ``dim``)."""
    sizes = axis_sizes(mesh)
    out = t.to(_reduce_type(t)).contiguous()
    for a in reversed(spec_axes(axes)):   # minor first: each gather concatenates blocks
        n = sizes[a]
        if n == 1:
            continue
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out, group=mesh.get_group(a))
        out = torch.cat(parts, dim=dim)
    return out.to(t.dtype)


def gather(local: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from every rank's shard under ``spec``."""
    out = local
    for d, entry in enumerate(spec):
        if entry is not None:
            out = all_gather(out, entry, mesh, d)
    return out
