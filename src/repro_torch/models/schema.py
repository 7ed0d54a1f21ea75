"""Parameter schema — the twin of :mod:`repro.models.schema`: one source of
truth for the shapes, initialisation and logical sharding axes of every
parameter.

Every layer module contributes ``{name: ParamDef}`` entries; ``init_tree``
materializes tensors and ``axes_tree`` gives the matching logical axes
(``"model"`` = the tensor/expert-parallel axis, ``None`` = replicated).

``init_tree`` is deterministic per leaf path, as the reference's is: each
leaf draws from its own ``torch.Generator`` seeded from the run's seed and
the stable hash of its path, on the target device. It does NOT reproduce
the JAX package's numbers (``jax.random`` and ``torch`` generate different
streams); to hold the two packages to the same weights, initialise with the
reference and carry the arrays over with
:func:`repro_torch.convert.params_from_numpy`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    #: logical partition axes, one per dim (None or "model")
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Schema = dict[str, "ParamDef | dict"]


def init_leaf(defn: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    dt = getattr(torch, defn.dtype)
    if defn.init == "zeros":
        return torch.zeros(defn.shape, dtype=dt, device=device)
    if defn.init == "ones":
        return torch.ones(defn.shape, dtype=dt, device=device)
    out = torch.randn(defn.shape, generator=generator, dtype=torch.float32,
                      device=device)
    return out.mul_(defn.scale).to(dt)


def init_tree(schema: Schema, seed: int, device, _path: str = "") -> dict:
    """Materialize a parameter tree from a schema on ``device``
    (deterministic per path: leaf ``path`` draws from a generator seeded
    with ``seed`` and ``_stable_hash(path)``)."""
    device = torch.device(device)
    out: dict = {}
    for name, sub in sorted(schema.items()):
        path = f"{_path}/{name}"
        if isinstance(sub, dict):
            out[name] = init_tree(sub, seed, device, path)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed((seed << 31) | _stable_hash(path))
            out[name] = init_leaf(sub, gen, device)
    return out


def shape_tree(schema: Schema) -> dict:
    """``(shape, torch dtype)`` tree (for allocation-free size accounting)."""
    out: dict = {}
    for name, sub in schema.items():
        if isinstance(sub, dict):
            out[name] = shape_tree(sub)
        else:
            out[name] = (sub.shape, getattr(torch, sub.dtype))
    return out


def axes_tree(schema: Schema) -> dict:
    """Logical-axes tree matching the parameter tree structure."""
    out: dict = {}
    for name, sub in schema.items():
        if isinstance(sub, dict):
            out[name] = axes_tree(sub)
        else:
            out[name] = sub.axes
    return out


def stack(schema: Schema, n: int) -> Schema:
    """Prefix every leaf with a stacking dim (the period-stacked layout)."""
    out: Schema = {}
    for name, sub in schema.items():
        if isinstance(sub, dict):
            out[name] = stack(sub, n)
        else:
            out[name] = ParamDef(
                shape=(n, *sub.shape),
                axes=(None, *sub.axes),
                init=sub.init,
                scale=sub.scale,
                dtype=sub.dtype,
            )
    return out


def count_params(schema: Schema) -> int:
    total = 0
    for sub in schema.values():
        if isinstance(sub, dict):
            total += count_params(sub)
        else:
            total += math.prod(sub.shape)
    return total


def _stable_hash(s: str) -> int:
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 % (1 << 31)
    return h
