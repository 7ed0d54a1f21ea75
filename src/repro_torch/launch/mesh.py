"""Production mesh construction — the twin of :mod:`repro.launch.mesh`, as
``torch.distributed`` DeviceMeshes over the current process group.

Single pod: 256 devices as (data=16, model=16). Multi-pod: 2 pods = 512
devices as (pod=2, data=16, model=16) — the pod axis is pure data
parallelism (gradient all-reduce crosses the inter-pod links; the model
axis stays intra-pod, mirroring the paper's "TP stays intra-node" rule).

Each rank calls the same function; the process group (its backend, world
size and rank) is the caller's, set up with
``torch.distributed.init_process_group`` before. Importing this module
touches no device and no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.device import resolve_device


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device):
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs a process group of {need} ranks; "
            "none is initialised (call torch.distributed.init_process_group first)")
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs a process group of {need} ranks; "
            f"this one has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(data 16, model 16), or (pod 2, data 16, model 16) with ``multi_pod``,
    on ``device``'s type (None = the card, raising when there is none)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A small (data, model) mesh over the current process group."""
    return _mesh((data, model), ("data", "model"), device)
