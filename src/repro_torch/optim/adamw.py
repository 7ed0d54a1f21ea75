"""AdamW + global-norm clipping + cosine schedule — the twin of
:mod:`repro.optim.adamw`, in PyTorch.

Moments are float32, the step counter int32, and the bias corrections
float32, as in the reference. Where the reference builds new trees, the
port updates the moments and the parameters in place (under
``torch.no_grad``) and returns the same dicts: at mamba2-2.7b's width the
moments alone are 22.6 GB, and a second copy would not fit beside them.

The ZeRO-1 moment sharding of the reference (``zero1_specs``,
``opt_state_specs``) needs a device mesh: it comes with the sharding slice
(ROADMAP.md, Queue 1).
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
    cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict
) -> tuple[dict, AdamWState]:
    """One AdamW step. ``params``, ``state.mu`` and ``state.nu`` are updated
    in place and returned, with a new step counter."""
    step = state.step + 1
    lr = schedule(cfg, step)

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
