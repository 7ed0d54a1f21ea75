"""AdamW + global-norm clipping + cosine schedule — the twin of
:mod:`repro.optim.adamw`, in PyTorch.

Moments are float32, the step counter int32, and the bias corrections
float32, as in the reference. Where the reference builds new trees, the
port updates the moments and the parameters in place (under
``torch.no_grad``) and returns the same dicts: at mamba2-2.7b's width the
moments alone are 22.6 GB, and a second copy would not fit beside them.

:func:`zero1_specs` and :func:`opt_state_specs` give the moments' ZeRO-1
sharding on a DeviceMesh, as the reference's do on a JAX mesh.
"""
from __future__ import annotations

import math
from collections.abc import Iterator
from dataclasses import dataclass
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict
    nu: dict


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def leaves(tree: dict, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """``(path, leaf)`` of a nested dict in the reference's flattening
    order (keys sorted at every level), paths ``/``-joined."""
    for name in sorted(tree):
        sub = tree[name]
        path = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(sub, dict):
            yield from leaves(sub, path)
        else:
            yield path, sub


def map_tree(fn, tree: dict) -> dict:
    """The same nested dict with ``fn`` applied to every leaf."""
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor), in float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init(params: dict) -> AdamWState:
    """Zero float32 moments beside each parameter, and step 0."""
    some = next(leaves(params))[1]
    zeros = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        mu=zeros,
        nu=map_tree(torch.clone, zeros),
    )


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's float32
    sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for _, x in leaves(tree)))


@torch.no_grad()
def update(
    cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict,
    gnorm: torch.Tensor | None = None,
) -> tuple[dict, AdamWState]:
    """One AdamW step. ``params``, ``state.mu`` and ``state.nu`` are updated
    in place and returned, with a new step counter. ``gnorm``: the global
    gradient norm, where ``grads`` holds only a rank's shards of it (None:
    ``global_norm(grads)``)."""
    step = state.step + 1
    lr = schedule(cfg, step)

    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    flat_g = dict(leaves(grads))
    flat_mu = dict(leaves(state.mu))
    flat_nu = dict(leaves(state.nu))
    for path, p in leaves(params):
        g = flat_g[path].float() * scale
        mu, nu = flat_mu[path], flat_nu[path]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        mhat = mu / bc1
        vhat = nu / bc2
        step_vec = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (step_vec + cfg.weight_decay * pf)
        p.copy_(pf)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


# ------------------------------------------------------------- sharding
def zero1_specs(param_spec_tree: dict, shapes: dict, mesh) -> dict:
    """Moment specs: like the parameter spec, plus ZeRO-1 sharding of the
    first still-replicated dimension over the DP axes when divisible.
    ``shapes`` is a tree of tensors or meta tensors
    (:func:`repro_torch.models.model.param_shapes`)."""
    from repro_torch.sharding import P
    from repro_torch.sharding.partition import batch_axes, mesh_axis_size

    ba = batch_axes(mesh)
    dp = mesh_axis_size(mesh, ba)

    def one(spec, shape):
        if dp <= 1:
            return spec
        dims = list(spec) + [None] * (len(shape.shape) - len(spec))
        # FSDP-sharded params already use the DP axes — a mesh axis can only
        # appear once per spec, and the moments inherit that sharding anyway.
        used = {a for s in dims if s for a in (s if isinstance(s, tuple) else (s,))}
        if used & set(ba):
            return P(*dims)
        for i, (d, s) in enumerate(zip(shape.shape, dims, strict=True)):
            if s is None and d % dp == 0 and d >= dp:
                dims[i] = ba
                return P(*dims)
        return spec

    def walk(specs, shapes):
        if isinstance(specs, P):
            return one(specs, shapes)
        return {k: walk(v, shapes[k]) for k, v in specs.items()}

    return walk(param_spec_tree, shapes)


def opt_state_specs(param_spec_tree: dict, shapes: dict, mesh) -> AdamWState:
    from repro_torch.sharding import P

    moment = zero1_specs(param_spec_tree, shapes, mesh)
    return AdamWState(step=P(), mu=moment, nu=moment)
