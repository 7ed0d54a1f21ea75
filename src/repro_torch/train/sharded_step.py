"""The even micro-batched train step on a DeviceMesh: each rank computes on
its local shards with explicit collectives, where the reference lets GSPMD
partition the unsharded step (``jax.jit`` with ``in_shardings``).

Inputs are the global values, as DTensors (their local shards are updated
in place): parameters placed by ``param_specs`` or ``fsdp_param_specs``,
the AdamW moments by ``opt_state_specs`` of those specs (ZeRO-1: a moment
also splits its first replicated dim over the DP axes), the step counter
replicated; the batch ``(slots, global_mb, S, ...)`` placed by
``train_batch_specs`` (DTensors, or whole tensors that every rank slices).

Per slot, the rank's micro-batch loss runs through the per-rank layers of
:mod:`repro_torch.models.sharded` (model axis column- and row-parallel
through autograd collectives, vocab-parallel cross-entropy, the
expert-parallel MoE where it applies, Mamba2 on a rank's heads, FSDP
weights gathered at use), one ``torch.utils.checkpoint`` per period as the
unsharded step remats, and its gradients are summed in float32. Then the
gradients are summed over the DP axes (an FSDP leaf's already are: its
gather's backward is a reduce-scatter) and divided by slots x DP ranks;
each rank updates its ZeRO-1 slice of every leaf (the clip norm is the
global one, every slice counted once) and all-gathers the updated slices
over the DP axes its moments add.

This is the unsharded step's function: the mean of the micro-batch losses
over the global micro-batch, one AdamW update. Two departures, both the
reference's own under a mesh: the expert-parallel MoE sizes its capacity
per data shard, and its aux loss is the mean of the data shards' (equal to
the unsharded step where no token is dropped and the data axis is 1).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, model as model_lib
from repro_torch.models import sharded as sh
from repro_torch.optim import adamw
from repro_torch.sharding import P
from repro_torch.sharding import partition as part
from repro_torch.sharding.manual import (
    all_gather, all_reduce, as_dtensor, is_dtensor, local_shard, split,
)
from repro_torch.train.train_step import _grads, _take_slot, _unflatten


def train_step(params, opt_state: adamw.AdamWState, batch: dict, cfg: ArchConfig,
               opt_cfg: adamw.AdamWConfig, mesh):
    """One step on ``mesh``; returns ``(params, opt_state, {"loss": ...})``
    with the parameters and moments updated in place (the same DTensors)."""
    trees = (params, opt_state.mu, opt_state.nu)
    if not all(is_dtensor(t) for tree in trees for _, t in adamw.leaves(tree)):
        raise TypeError("the sharded train step updates parameters and moments in place: "
                        "pass DTensors (repro_torch.sharding.partition.distribute)")
    ba = part.batch_axes(mesh)
    dp = part.mesh_axis_size(mesh, ba)
    paths = [path for path, _ in adamw.leaves(params)]
    pspec = {path: part.spec_of(t) for path, t in adamw.leaves(params)}
    mspec = {path: part.spec_of(t) for path, t in adamw.leaves(opt_state.mu)}
    store = [t.to_local().detach() for _, t in adamw.leaves(params)]
    flat = [t.detach().requires_grad_(True) for t in store]
    p_loc = _unflatten(paths, flat)
    specs = _unflatten(paths, [pspec[path] for path in paths])
    bspecs = part.train_batch_specs(cfg, mesh)
    local = {k: local_shard(v, part.spec_of(v) if is_dtensor(v) else bspecs[k], mesh)
             for k, v in batch.items()}

    slots = local[sorted(local)[0]].shape[0]
    gsum = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in flat]
    lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for i in range(slots):
        loss = loss_fn(p_loc, specs, _take_slot(local, i, cfg), cfg, mesh)
        grads = _grads(loss, flat, paths, cfg)
        with torch.no_grad():
            for acc, g in zip(gsum, grads):
                if g is not None:
                    acc.add_(g)
        del grads
        lsum = lsum + loss.detach()

    with torch.no_grad():
        grads, p_sl, norm_sq = [], [], torch.zeros((), dtype=torch.float32,
                                                   device=flat[0].device)
        world = math.prod(part.axis_sizes(mesh).values())
        for path, g, p in zip(paths, gsum, store):
            if not _dp_dims(pspec[path], ba):
                g = all_reduce(g, ba, mesh)
            g = g.div_(slots * dp)
            d, entry = _zero1_dim(pspec[path], mspec[path])
            if entry is not None:
                g, p = split(g, entry, mesh, d), split(p, entry, mesh, d)
            grads.append(g)
            p_sl.append(p)
            held = math.prod(part.mesh_axis_size(mesh, part.spec_axes(e))
                             for e in mspec[path])
            norm_sq = norm_sq + torch.sum(torch.square(g)) * (held / world)
        gnorm = torch.sqrt(all_reduce(norm_sq, tuple(mesh.mesh_dim_names), mesh))
        step = opt_state.step.to_local() if is_dtensor(opt_state.step) else opt_state.step
        mu = _unflatten(paths, [t.to_local() for _, t in adamw.leaves(opt_state.mu)])
        nu = _unflatten(paths, [t.to_local() for _, t in adamw.leaves(opt_state.nu)])
        _, new = adamw.update(opt_cfg, _unflatten(paths, grads),
                              adamw.AdamWState(step=step, mu=mu, nu=nu),
                              _unflatten(paths, p_sl), gnorm=gnorm)
        for path, p, sl in zip(paths, store, p_sl):
            d, entry = _zero1_dim(pspec[path], mspec[path])
            if entry is not None:
                p.copy_(all_gather(sl, entry, mesh, d))
        loss = all_reduce(lsum, ba, mesh) / (slots * dp)
    step = new.step
    if is_dtensor(opt_state.step):
        step = as_dtensor(step, P(), mesh, shape=())
    return params, adamw.AdamWState(step=step, mu=opt_state.mu, nu=opt_state.nu), \
        {"loss": loss}


def loss_fn(p: dict, spec: dict, mb: dict, cfg: ArchConfig, mesh):
    """This rank's micro-batch loss: the mean cross-entropy of its tokens
    (+ the MoE aux loss), the same value on every rank of a model group;
    each period checkpointed under autograd."""
    ba = part.batch_axes(mesh)
    x = sh.embed(*sh.use_tree(p["embed"], spec["embed"], mesh),
                 mb["embeds"] if cfg.modality == "vision_embeds" else mb["tokens"], cfg, mesh)
    positions = model_lib._positions(mb, cfg, x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_periods):
        pspec = sh.period(spec["blocks"], i)

        def body(h, aux_sum, period, pspec=pspec):
            for j, sub in enumerate(cfg.period):
                key = f"sub{j}"
                if sub.mixer == "attn":
                    h = h + sh.attention_step(
                        *sh.use_tree(period[key]["attn"], pspec[key]["attn"], mesh), h, cfg,
                        positions, 0, mesh)[0]
                else:
                    h = h + sh.mamba(*sh.use_tree(period[key]["mamba"], pspec[key]["mamba"],
                                                  mesh), h, cfg, mesh)[0]
                if sub.mlp == "mlp":
                    h = h + sh.mlp(*sh.use_tree(period[key]["mlp"], pspec[key]["mlp"], mesh),
                                   h, cfg, mesh)
                elif sub.mlp == "moe":
                    y, a = sh.moe(*sh.use_tree(period[key]["moe"], pspec[key]["moe"], mesh),
                                  h, ba, cfg, mesh)
                    h, aux_sum = h + y, aux_sum + a
            return h, aux_sum

        period = sh.period(p["blocks"], i)
        if torch.is_grad_enabled():
            x, aux = checkpoint(body, x, aux, period, use_reentrant=False,
                                preserve_rng_state=False)   # the model draws nothing
        else:
            x, aux = body(x, aux, period)
    final_norm, _ = sh.use(p["final_norm"], spec["final_norm"], mesh)
    x = layers.rmsnorm(x, final_norm, cfg.norm_eps)
    hp, hs = sh.use_tree(p["head"], spec["head"], mesh)
    vs, col0 = sh.head_col0(hp, hs, cfg, mesh)
    ce = sh.cross_entropy(sh.head(hp, hs, x, cfg, mesh), mb["labels"], vs, col0, mesh)
    return ce + model_lib.AUX_LOSS_COEF * aux


def _dp_dims(spec: P, ba) -> bool:
    """Whether ``spec`` splits a dim over DP axes (an FSDP leaf)."""
    return any(set(part.spec_axes(e)) & set(ba) for e in spec)


def _zero1_dim(pspec: P, mspec: P):
    """(dim, spec entry) that the moment's spec splits and the
    parameter's does not (ZeRO-1), or (None, None)."""
    for d, (pe, me) in enumerate(zip(pspec, mspec)):
        if pe != me:
            return d, me
    return None, None
