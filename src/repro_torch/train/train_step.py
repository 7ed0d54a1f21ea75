"""Micro-batched training step — the twin of ``make_train_step`` in
:mod:`repro.train.train_step`.

Even micro-batching: for each slot of the batch, the micro-batch loss and
its gradients (``torch.autograd.grad``, so that no bfloat16 ``.grad`` field
rounds the sum), summed into float32 buffers in slot order, divided by the
slot count, then one AdamW update. The reference's ``lax.scan`` over slots
is a Python loop here.

The FALCON S2 variant (``make_adaptive_train_step``: per-DP-group trip
counts inside a ``shard_map`` over a device mesh) comes with the sharding
slice (ROADMAP.md, Queue 1).

Batch layout: ``(slots, global_microbatch, S, ...)`` — see
:mod:`repro_torch.data.pipeline`.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw


def _microbatch_loss(params, mb, cfg: ArchConfig, use_kernel: bool):
    return model_lib.loss_fn(params, mb, cfg, use_kernel=use_kernel)


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    use_kernel: bool = False,
) -> Callable:
    """Even micro-batching over all slots. The returned
    ``train_step(params, opt_state, batch)`` updates ``params`` and the
    moments in place and returns ``(params, opt_state, {"loss": ...})``.
    Parameters that do not require grad are switched to require it.

    ``use_kernel`` takes the CUDA SSD scan, which has no gradient: it raises
    here as the reference's kernel does under ``jax.grad``."""

    def train_step(params, opt_state, batch):
        slots = batch[sorted(batch)[0]].shape[0]
        paths, flat = zip(*adamw.leaves(params))
        for p in flat:
            if not p.requires_grad:
                p.requires_grad_(True)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
        lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for i in range(slots):
            mb = _take_slot(batch, i, cfg)
            loss, _ = _microbatch_loss(params, mb, cfg, use_kernel)
            grads = torch.autograd.grad(loss, flat)
            with torch.no_grad():
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
            del grads
            lsum = lsum + loss.detach()
        with torch.no_grad():
            for acc in gsum:
                acc.div_(slots)
        grads = _unflatten(paths, gsum)
        params, opt_state = adamw.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {"loss": lsum / slots}

    return train_step


def _unflatten(paths, values) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        *parents, name = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = v
    return out


def _take_slot(batch: dict, i: int, cfg: ArchConfig) -> dict:
    out = {}
    for k, v in batch.items():
        if k == "positions":  # (3, B, S) — shared across slots
            out[k] = v
        else:
            out[k] = v[i]
    return out
