"""Micro-batched training step — the twin of ``make_train_step`` in
:mod:`repro.train.train_step`.

Even micro-batching: for each slot of the batch, the micro-batch loss and
its gradients (``torch.autograd.grad``, so that no bfloat16 ``.grad`` field
rounds the sum), summed into float32 buffers in slot order, divided by the
slot count, then one AdamW update. The reference's ``lax.scan`` over slots
is a Python loop here. Under an ambient mesh the step runs per rank on
local shards (:mod:`repro_torch.train.sharded_step`).

``make_adaptive_train_step`` is the FALCON S2 variant on a DeviceMesh:
each DP group runs its *own* micro-batch allocation ``counts[g]`` (the
reference's ``lax.while_loop`` inside a ``shard_map`` manual over the DP
axes), and the gradient sums and the counts meet in all-reduces over the DP
groups, so the update uses the paper's weighted mean sum(grads) / sum(m).
The model axis stays replicated: every rank of a DP group runs the same
micro-batches on the whole parameters (with unsharded parameters GSPMD also
keeps the reference's auto model axis replicated).

Batch layout: ``(slots, global_microbatch, S, ...)`` — see
:mod:`repro_torch.data.pipeline`.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.sharding import ambient_mesh


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
    here as the reference's kernel does under ``jax.grad``.

    Under an ambient mesh (:func:`repro_torch.sharding.set_mesh`) the step
    runs per rank on DTensor shards (:mod:`repro_torch.train.sharded_step`,
    plain routes only)."""

    def train_step(params, opt_state, batch):
        mesh = ambient_mesh()
        if mesh is not None:
            from repro_torch.train import sharded_step

            if use_kernel:
                raise ValueError("the sharded train step runs the plain routes only")
            return sharded_step.train_step(params, opt_state, batch, cfg, opt_cfg, mesh)
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
            grads = _grads(loss, flat, paths, cfg)
            with torch.no_grad():
                for acc, g in zip(gsum, grads):
                    if g is not None:
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


def make_adaptive_train_step(
    cfg: ArchConfig,
    opt_cfg: adamw.AdamWConfig,
    mesh,
    *,
    use_kernel: bool = False,
) -> Callable:
    """FALCON S2 step: per-DP-group trip counts + weighted gradients.

    The returned ``train_step(params, opt_state, batch, counts)`` is called
    by every rank of ``mesh`` with the same arguments: ``params`` and
    ``opt_state`` whole on every rank (updated in place, as
    :func:`make_train_step` does), ``batch`` the global (slots, global_mb,
    S, ...) batch (whole tensors, or DTensors placed by
    ``train_batch_specs``), ``counts`` the micro-batches of each DP group
    (length = the DP size, groups in mesh order). Group g runs its first
    ``counts[g]`` slots on its columns of the batch."""
    from repro_torch.sharding import P
    from repro_torch.sharding.manual import all_reduce, axis_index, local_shard
    from repro_torch.sharding.partition import batch_axes, mesh_axis_size, spec_axes
    from repro_torch.sharding.partition import train_batch_specs

    ba = batch_axes(mesh)
    dp = mesh_axis_size(mesh, ba)
    # Manual only over the DP axes: drop other axis names from the specs.
    bspecs = {k: P(*[tuple(a for a in spec_axes(e) if a in ba) or None for e in spec])
              for k, spec in train_batch_specs(cfg, mesh).items()}

    def train_step(params, opt_state, batch, counts):
        if len(counts) != dp:
            raise ValueError(f"counts has {len(counts)} entries for {dp} DP groups")
        m = int(counts[axis_index(mesh, ba)])    # this DP group's allocation
        local = {k: local_shard(v, bspecs[k], mesh) for k, v in batch.items()}
        paths, flat = zip(*adamw.leaves(params))
        for p in flat:
            if not p.requires_grad:
                p.requires_grad_(True)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
        lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for i in range(m):
            mb = _take_slot(local, i, cfg)
            loss, _ = _microbatch_loss(params, mb, cfg, use_kernel)
            grads = _grads(loss, flat, paths, cfg)
            with torch.no_grad():
                for acc, g in zip(gsum, grads):
                    if g is not None:
                        acc.add_(g)
            del grads
            lsum = lsum + loss.detach()
        # Weighted gradient aggregation (paper §5.3): each group contributes
        # its gradient *sum*; dividing by the global micro-batch count gives
        # weights m_i / M.
        total = float(sum(int(c) for c in counts))
        with torch.no_grad():
            gsum = [all_reduce(acc, ba, mesh).div_(total) for acc in gsum]
        loss = all_reduce(lsum, ba, mesh) / total
        grads = _unflatten(paths, gsum)
        params, opt_state = adamw.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step


def _grads(loss, flat, paths, cfg: ArchConfig) -> list:
    """``loss``'s gradient for each leaf. A vision model's token table takes
    no part (its inputs are embeds): its gradient is None, where jax.grad
    gives zeros. Any other leaf that the loss does not reach raises."""
    skip = "embed/tok" if cfg.modality == "vision_embeds" else None
    used = [i for i, path in enumerate(paths) if path != skip]
    grads = [None] * len(flat)
    for i, g in zip(used, torch.autograd.grad(loss, [flat[i] for i in used])):
        grads[i] = g
    return grads


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
