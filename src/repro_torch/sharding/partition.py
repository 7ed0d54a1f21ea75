"""Resolve logical parameter/activation axes against a concrete mesh — the
twin of :mod:`repro.sharding.partition`, on a ``torch.distributed``
:class:`~torch.distributed.device_mesh.DeviceMesh`.

Safety rule: a dimension is sharded on a mesh axis only when its size is
divisible by that axis — otherwise it is replicated (the Megatron-standard
fallback, e.g. KV projections with kv_heads < TP degree). This keeps every
(architecture x mesh) combination valid without per-arch exceptions.

The spec functions read only the mesh's axis names and sizes, as the
reference reads only ``mesh.shape``, so they take any DeviceMesh, one over
a fake process group included. :func:`named` turns a spec into DTensor
placements, and :func:`distribute` (the counterpart of ``jax.device_put``
with a ``NamedSharding``) gives each rank its local shards of a full tree
as DTensors. A tensor dimension split over several mesh axes splits them
major to minor in the order the spec names them, as in JAX; DTensor splits
over mesh dimensions in mesh order, so such a spec must name its axes in
mesh order (every spec of this module does) and :func:`named` raises on
one that does not.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding import P


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))


def mesh_axis_size(mesh, axis: str | tuple[str, ...]) -> int:
    shape = axis_sizes(mesh)
    if isinstance(axis, str):
        return shape.get(axis, 1)
    size = 1
    for a in axis:
        size *= shape.get(a, 1)
    return size


def batch_axes(mesh) -> tuple[str, ...]:
    """The data-parallel mesh axes: ("pod", "data") when a pod axis exists."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def resolve_leaf_spec(
    shape: tuple[int, ...],
    axes: tuple[str | None, ...],
    mesh,
) -> P:
    out: list = []
    for dim, ax in zip(shape, axes, strict=True):
        if ax is None:
            out.append(None)
        else:
            size = mesh_axis_size(mesh, ax)
            out.append(ax if size > 1 and dim % size == 0 else None)
    return P(*out)


def schema_specs(schema: dict, mesh) -> dict:
    """Tree of :class:`P` resolved from a parameter Schema."""
    out: dict = {}
    for name, sub in schema.items():
        if isinstance(sub, dict):
            out[name] = schema_specs(sub, mesh)
        else:
            out[name] = resolve_leaf_spec(sub.shape, sub.axes, mesh)
    return out


def param_specs(cfg: ArchConfig, mesh) -> dict:
    from repro_torch.models.model import model_schema

    return schema_specs(model_schema(cfg), mesh)


def fsdp_param_specs(cfg: ArchConfig, mesh, min_dim: int = 2048) -> dict:
    """Param specs with additional FSDP-style sharding over the DP axes.

    For models whose model-axis shard alone exceeds device memory, each
    large parameter also shards one unsharded dimension over
    ("pod","data"), gathered at use. Small tensors (norms, biases, dims <
    ``min_dim``) stay replicated — gathering them wouldn't pay for the
    latency.
    """
    from repro_torch.models.model import model_schema

    ba = batch_axes(mesh)
    dsize = mesh_axis_size(mesh, ba)

    def widen(schema: dict) -> dict:
        out: dict = {}
        for name, sub in schema.items():
            if isinstance(sub, dict):
                out[name] = widen(sub)
                continue
            spec = list(resolve_leaf_spec(sub.shape, sub.axes, mesh))
            # Pick the largest still-unsharded dim divisible by the DP size.
            # 1-D params (norm scales, biases) stay replicated.
            cands = [
                (dim, i)
                for i, (dim, s) in enumerate(zip(sub.shape, spec))
                if len(sub.shape) >= 2
                and s is None and dim % dsize == 0 and dim >= min_dim
            ]
            if cands:
                _, i = max(cands)
                spec[i] = ba if len(ba) > 1 else ba[0]
            out[name] = P(*spec)
        return out

    return widen(model_schema(cfg))


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dimension,
    ``Shard(tensor dim)`` where the spec names that axis, else
    ``Replicate()``. Raises ValueError for an axis the mesh lacks, an axis
    named twice, or a dimension whose axes are not in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for tdim, entry in enumerate(spec):
        prev = -1
        for a in spec_axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of {names}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names {a!r} twice")
            if i < prev:
                raise ValueError(
                    f"spec {spec}: dim {tdim} splits over {spec_axes(entry)}, not in "
                    f"the mesh's major-to-minor order {names}")
            prev = i
            out[i] = Shard(tdim)
    return tuple(out)


def spec_of(dtensor) -> P:
    """The spec of a DTensor's placements (the inverse of :func:`placements`)."""
    from torch.distributed.tensor import Shard

    entries: list[list[str]] = [[] for _ in range(dtensor.ndim)]
    for name, pl in zip(dtensor.device_mesh.mesh_dim_names, dtensor.placements, strict=True):
        if isinstance(pl, Shard):
            entries[pl.dim % dtensor.ndim].append(name)
    return P(*[tuple(e) if e else None for e in entries])


def _map_specs(fn, specs):
    if isinstance(specs, P):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def named(specs, mesh):
    """The tree of :class:`P` as a tree of DTensor placements on ``mesh``."""
    return _map_specs(lambda s: placements(s, mesh), specs)


def shard_slices(shape, spec: P, sizes: dict[str, int], coord: dict[str, int]) -> tuple:
    """The slices of a ``shape`` tensor that the device at mesh coordinate
    ``coord`` holds under ``spec``: dimension d split into the product of its
    axes' sizes, the first axis the most major (JAX's order)."""
    out = []
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        n, idx = 1, 0
        for a in spec_axes(entry):
            n *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {entry}")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def coordinate(mesh) -> dict[str, int]:
    """This rank's ``{axis name: index}`` on ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, coord, strict=True))


def distribute(tree, specs, mesh):
    """``jax.device_put(tree, named(specs))``: every rank passes the same full
    tree (nested dicts of tensors, or one tensor with one spec) and gets a
    DTensor per leaf whose local tensor is a copy of its own shard."""
    from torch.distributed.tensor import DTensor

    sizes, coord = axis_sizes(mesh), coordinate(mesh)

    def one(t, spec):
        local = t[shard_slices(t.shape, spec, sizes, coord)].clone()
        return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                                  shape=t.shape, stride=t.contiguous().stride())

    if isinstance(specs, P):
        return one(tree, specs)
    return {k: distribute(tree[k], specs[k], mesh) for k in specs}


# ---------------------------------------------------------- batch specs
def train_batch_specs(cfg: ArchConfig, mesh) -> dict:
    """Specs for the (slots, global_mb, S[, ...]) training batch layout.

    dim 1 (the per-slot global micro-batch of sequences) is sharded across
    the DP axes; everything else is replicated.
    """
    ba = batch_axes(mesh)
    if cfg.modality == "vision_embeds":
        return {
            "embeds": P(None, ba, None, None),
            "positions": P(None, ba, None),  # (3, B, S)
            "labels": P(None, ba, None),
        }
    if cfg.modality == "audio_codes":
        return {
            "tokens": P(None, ba, None, None),
            "labels": P(None, ba, None, None),
        }
    return {"tokens": P(None, ba, None), "labels": P(None, ba, None)}


def serve_batch_specs(cfg: ArchConfig, mesh, batch: int) -> dict:
    """Specs for a (B, S[, ...]) prefill/decode request batch; if B doesn't
    divide the DP axes the batch dim is replicated and the *sequence* gets
    the sharding (sequence-parallel serving)."""
    ba = batch_axes(mesh)
    dp = mesh_axis_size(mesh, ba)
    bdim = ba if batch % dp == 0 else None
    sdim = None if bdim is not None else ba
    if cfg.modality == "vision_embeds":
        return {
            "embeds": P(bdim, sdim, None),
            "positions": P(None, bdim, sdim),
        }
    if cfg.modality == "audio_codes":
        return {"tokens": P(bdim, sdim, None)}
    return {"tokens": P(bdim, sdim)}


def decode_token_specs(cfg: ArchConfig, mesh, batch: int) -> P:
    """Spec for the (B, 1[, ...]) decode token: batch over DP if divisible,
    otherwise fully replicated (the cache carries the sharding instead)."""
    ba = batch_axes(mesh)
    dp = mesh_axis_size(mesh, ba)
    bdim = ba if batch % dp == 0 else None
    if cfg.modality in ("vision_embeds", "audio_codes"):
        return P(bdim, None, None)
    return P(bdim, None)


def cache_specs(cfg: ArchConfig, mesh, batch: int, *, seq_shard: bool = True) -> dict:
    """Specs for the decode caches (leading n_periods stack dim).

    Attention KV caches: (L, B, S, KV, hd) — batch over DP axes when it
    divides, otherwise the *sequence* dim is sharded; KV heads over the
    model axis when divisible.

    ``seq_shard``: when the KV heads do NOT divide the model axis, shard the
    cache *sequence* over the model axis instead of replicating the whole
    cache (flash-decode: each shard attends to its slice and the partial
    softmaxes are combined; :mod:`repro_torch.serve.serve_step`).
    SSM caches: (L, B, H, P, N) — heads over model.
    """
    ba = batch_axes(mesh)
    dp = mesh_axis_size(mesh, ba)
    tp = mesh_axis_size(mesh, "model")
    bdim = ba if batch % dp == 0 else None
    sdim = None if bdim is not None else ba

    out: dict = {}
    for j, sub in enumerate(cfg.period):
        if sub.mixer == "attn":
            kvdim = "model" if cfg.num_kv_heads % tp == 0 and tp > 1 else None
            kv_sdim = sdim
            if seq_shard and kvdim is None and tp > 1:
                # Fold the model axis onto the cache sequence dim.
                kv_sdim = (
                    (*sdim, "model") if isinstance(sdim, tuple)
                    else ((sdim, "model") if sdim else "model")
                )
            spec = {
                "k": P(None, bdim, kv_sdim, kvdim, None),
                "v": P(None, bdim, kv_sdim, kvdim, None),
            }
        else:
            hdim = "model" if cfg.ssm_heads % tp == 0 and tp > 1 else None
            spec = {
                "state": P(None, bdim, hdim, None, None),
                "conv_x": P(None, bdim, None,
                            "model" if cfg.ssm_inner % tp == 0 and tp > 1 else None),
                "conv_bc": P(None, bdim, None, None),
            }
        out[f"sub{j}"] = spec
    return out


def logits_spec(cfg: ArchConfig, mesh, batch: int) -> P:
    ba = batch_axes(mesh)
    dp = mesh_axis_size(mesh, ba)
    tp = mesh_axis_size(mesh, "model")
    vdim = "model" if cfg.padded_vocab % tp == 0 and tp > 1 else None
    bdim = ba if batch % dp == 0 else None
    if cfg.modality == "audio_codes":
        return P(bdim, None, None, vdim)
    return P(bdim, None, vdim)
