"""Multi-process runs of the port's mesh code for the CPU tests: a spawn
harness over gloo (``file://`` rendezvous, a timeout on every wait) and the
per-rank programs the tests run. Imports torch and ``repro_torch`` only, so
that a rank's ``sys.modules`` shows what the port loads."""
from __future__ import annotations

import datetime
import os
import sys
import time
import traceback

import numpy as np

#: seconds a collective may wait before the rank fails
COLLECTIVE_TIMEOUT = 120


def spawn(fn, world: int, workdir: str, *args, timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    by a gloo process group; returns each rank's result (what ``fn``
    returned, via ``np.save``/pickle-free ``.npz``). Raises RuntimeError with
    the rank's traceback if a rank fails, or if one is still running after
    ``timeout`` seconds (all are then terminated)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    os.makedirs(workdir, exist_ok=True)
    for rank in range(world):
        for stale in (f"error{rank}.txt", f"result{rank}.npz"):
            if os.path.exists(os.path.join(workdir, stale)):
                os.remove(os.path.join(workdir, stale))
    init = "file://" + os.path.join(os.path.abspath(workdir), "rendezvous")
    procs = [ctx.Process(target=_entry, args=(fn, rank, world, init, workdir, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    errors = []
    for rank, p in enumerate(procs):
        err = os.path.join(workdir, f"error{rank}.txt")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
        elif p.exitcode != 0 and rank not in hung:
            errors.append(f"rank {rank} exited with {p.exitcode}")
    if hung:
        errors.append(f"ranks {hung} still running after {timeout} s")
    if errors:
        raise RuntimeError("\n".join(errors))
    out = []
    for rank in range(world):
        with np.load(os.path.join(workdir, f"result{rank}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _entry(fn, rank, world, init, workdir, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            result = fn(rank, world, *args)
            result["modules"] = np.array(sorted(
                m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"), dtype=str)
            np.savez(os.path.join(workdir, f"result{rank}.npz"), **result)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ------------------------------------------------------------------ programs
def _f32(t):
    return t.detach().float().cpu().numpy()


def _tree_from_npz(z, prefix):
    """Nested dict of the arrays whose keys start with ``prefix/``."""
    out: dict = {}
    for k in z.files:
        if not k.startswith(prefix + "/"):
            continue
        node = out
        *parents, name = k[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = z[k]
    return out


def _mesh(shape):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(*shape, device="cpu")


def decode_cases(rank, world, inputs_path, cases):
    """Each case: (name, arch, mesh shape, batch, seq_shard, use_kernel,
    dtype, config overrides); the sharded decode over the case's positions,
    the logits and caches gathered whole."""
    import torch
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve.serve_step import make_decode_step
    from repro_torch.sharding import set_mesh
    from repro_torch.sharding import partition as part
    from repro_torch.sharding.manual import gather

    z = np.load(inputs_path)
    out = {}
    for name, arch, shape, b, seq_shard, use_kernel, dtype, overrides in cases:
        cfg = replace(get_config(arch).smoke(), dtype=dtype, **overrides)
        dt = getattr(torch, dtype)
        params = _cast(params_from_numpy(_tree_from_npz(z, f"{arch}/params"), device="cpu"), dt)
        mesh = _mesh(shape)
        caches = {k: {n: torch.as_tensor(a[:, :b]).to(dt) for n, a in c.items()}
                  for k, c in _tree_from_npz(z, f"{arch}/caches").items()}
        tokens = torch.as_tensor(z[f"{arch}/tokens"][:, :b])
        positions = z[f"{arch}/positions"]
        s = int(z[f"{arch}/seq_len"])
        step = make_decode_step(cfg, s, use_kernel=use_kernel)
        p_d = part.distribute(params, part.param_specs(cfg, mesh), mesh)
        c_d = part.distribute(caches, part.cache_specs(cfg, mesh, b, seq_shard=seq_shard), mesh)
        tspec = part.decode_token_specs(cfg, mesh, b)
        with set_mesh(mesh), torch.no_grad():
            for i, pos in enumerate(positions):
                tok = part.distribute(tokens[i], tspec, mesh)
                logits, c_d = step(p_d, tok, c_d, int(pos))
                out[f"{name}/logits{i}"] = _f32(gather(logits.to_local(),
                                                       part.spec_of(logits), mesh))
        for k, c in c_d.items():
            for n, t in c.items():
                out[f"{name}/caches/{k}/{n}"] = _f32(gather(t.to_local(), part.spec_of(t), mesh))
    return out


def _cast(tree, dt):
    return {k: _cast(v, dt) if isinstance(v, dict) else v.to(dt) for k, v in tree.items()}


def moe_cases(rank, world, inputs_path, cases):
    """Each case: (name, capacity_factor or None, batch, seq, as DTensors);
    one olmoe smoke MoE layer in float32 through ``apply_moe`` under a
    (data 2, model 2) mesh, and the local dispatch on the same tokens."""
    import torch
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import moe
    from repro_torch.sharding import set_mesh
    from repro_torch.sharding import partition as part

    z = np.load(inputs_path)
    params = params_from_numpy(_tree_from_npz(z, "moe/params"), device="cpu")
    x_all = torch.as_tensor(z["moe/x"])
    mesh = _mesh((2, 2))
    out = {}
    for name, cf, b, s, dtensors in cases:
        cfg = replace(get_config("olmoe-1b-7b").smoke(), dtype="float32")
        if cf is not None:
            cfg = replace(cfg, capacity_factor=cf)
        x = x_all[:b, :s]
        with torch.no_grad():
            y_local, aux_local = moe.apply_moe(params, x, cfg)
            with set_mesh(mesh):
                if dtensors:
                    ba = part.batch_axes(mesh) if b % 2 == 0 else ()
                    wspec, bspec = moe.ep_specs(cfg, ba)
                    y, aux = moe.apply_moe(part.distribute(params, wspec, mesh),
                                           part.distribute(x, bspec, mesh), cfg)
                    y = y.full_tensor()
                else:
                    y, aux = moe.apply_moe(params, x, cfg)
        out[f"{name}/y"], out[f"{name}/aux"] = _f32(y), _f32(aux)
        out[f"{name}/y_local"], out[f"{name}/aux_local"] = _f32(y_local), _f32(aux_local)
    return out


def adaptive_step(rank, world, inputs_path, counts, opt_kw):
    """One adaptive step of falcon-demo smoke (float32) over (data 2, model
    2) with ``counts``, and the one-process step on the weighted gradient."""
    import torch
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    cfg = replace(get_config("falcon-demo-100m").smoke(), dtype="float32")
    z = np.load(inputs_path)
    opt_cfg = adamw.AdamWConfig(**opt_kw)
    data = DataConfig(seq_len=32, global_batch=8, slots=4, dp_groups=2)
    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg, data, 0).items()}
    params = params_from_numpy(_tree_from_npz(z, "train/params"), device="cpu")
    step = ts.make_adaptive_train_step(cfg, opt_cfg, _mesh((2, 2)))
    params, _, metrics = step(params, adamw.init(params), batch, counts)
    out = {f"params/{k}": _f32(v) for k, v in adamw.leaves(params)}
    out["loss"] = _f32(metrics["loss"])
    if rank == 0:
        out.update(_one_process_step(cfg, opt_cfg, z, batch, counts))
    return out


def _one_process_step(cfg, opt_cfg, z, batch, counts):
    """The weighted-gradient step in one process: group g's first counts[g]
    slots of its columns, every gradient summed, divided by sum(counts)."""
    import torch

    from repro_torch.convert import params_from_numpy
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import _unflatten

    params = params_from_numpy(_tree_from_npz(z, "train/params"), device="cpu")
    paths, flat = zip(*adamw.leaves(params))
    for p in flat:
        p.requires_grad_(True)
    gsum = [torch.zeros_like(p) for p in flat]
    cols = batch["tokens"].shape[1] // len(counts)
    total = 0.0
    for g, m in enumerate(counts):
        for i in range(m):
            mb = {k: v[i, g * cols:(g + 1) * cols] for k, v in batch.items()}
            loss, _ = model_lib.loss_fn(params, mb, cfg)
            for acc, gr in zip(gsum, torch.autograd.grad(loss, flat)):
                acc.add_(gr.detach())
            total += float(loss)
    grads = _unflatten(paths, [g / sum(counts) for g in gsum])
    params, _ = adamw.update(opt_cfg, grads, adamw.init(params), params)
    out = {f"one/{k}": _f32(v) for k, v in adamw.leaves(params)}
    out["one_loss"] = np.float32(total / sum(counts))
    return out


def remap(rank, world, perm):
    """Each rank's coordinate on a (data 2, model 2) mesh and on
    ``remap_mesh`` of it with ``perm``."""
    from repro_torch.train.trainer import remap_mesh

    mesh = _mesh((2, 2))
    new = remap_mesh(mesh, perm)
    return {"coord": np.array(mesh.get_coordinate()),
            "new_coord": np.array(new.get_coordinate()),
            "new_ranks": new.mesh.numpy()}


def distribute_matches_dtensor(rank, world, specs):
    """``distribute``'s local shard equals DTensor's own
    ``distribute_tensor`` with ``named``'s placements, for each spec on a
    (data 2, model 2) mesh."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding import P
    from repro_torch.sharding import partition as part

    mesh = _mesh((2, 2))
    full = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    same = []
    for spec in specs:
        spec = P(*spec)
        ours = part.distribute(full, spec, mesh).to_local()
        theirs = distribute_tensor(full, mesh, part.placements(spec, mesh)).to_local()
        same.append(bool(torch.equal(ours, theirs)))
    return {"same": np.array(same)}


def _specs(cfg, mesh, fsdp_min_dim):
    from repro_torch.sharding import partition as part

    if fsdp_min_dim is None:
        return part.param_specs(cfg, mesh)
    return part.fsdp_param_specs(cfg, mesh, min_dim=fsdp_min_dim)


def _case_cfg(arch, dtype, overrides):
    from dataclasses import replace

    from repro_torch.configs.base import get_config

    return replace(get_config(arch).smoke(), dtype=dtype, **overrides)


def _batch(z, prefix, dt):
    """The batch arrays under ``prefix/`` as tensors (embeds in ``dt``)."""
    import torch

    return {k: torch.as_tensor(v).to(dt) if k == "embeds" else torch.as_tensor(v)
            for k, v in _tree_from_npz(z, prefix).items()}


def prefill_cases(rank, world, inputs_path, cases):
    """Each case: (name, arch, mesh shape, dtype, config overrides, FSDP
    min_dim or None, seq_shard, grow, batch); the sharded prefill of the
    first ``batch`` prompts under ``set_mesh``, the logits and caches
    gathered whole; with ``grow``, the caches grown by ``grow`` positions
    and one decode step from the prompt's end."""
    import torch

    from repro_torch.convert import params_from_numpy
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    from repro_torch.serve.sharded_prefill import grow_caches
    from repro_torch.sharding import set_mesh
    from repro_torch.sharding import partition as part
    from repro_torch.sharding.manual import gather

    z = np.load(inputs_path)
    out = {}
    for name, arch, shape, dtype, overrides, fsdp_min_dim, seq_shard, grow, b in cases:
        cfg = _case_cfg(arch, dtype, overrides)
        dt = getattr(torch, dtype)
        mesh = _mesh(shape)
        params = _cast(params_from_numpy(_tree_from_npz(z, f"{arch}/params"), device="cpu"), dt)
        p_d = part.distribute(params, _specs(cfg, mesh, fsdp_min_dim), mesh)
        batch = {k: v[:, :b] if k == "positions" else v[:b]
                 for k, v in _batch(z, f"{arch}/prompt", dt).items()}
        s = batch["embeds" if "embeds" in batch else "tokens"].shape[1]
        with set_mesh(mesh):
            logits, caches = make_prefill_step(cfg, s, seq_shard=seq_shard)(p_d, batch)
            out[f"{name}/logits"] = _f32(gather(logits.to_local(), part.spec_of(logits), mesh))
            for k, c in caches.items():
                for n, t in c.items():
                    out[f"{name}/caches/{k}/{n}"] = _f32(gather(t.to_local(), part.spec_of(t),
                                                                mesh))
            if grow:
                caches = grow_caches(caches, cfg, s + grow, mesh)
                tok = torch.as_tensor(z[f"{arch}/next"][:b])
                with torch.no_grad():
                    lg, _ = make_decode_step(cfg, s + grow)(p_d, tok, caches, s)
                out[f"{name}/next_logits"] = _f32(gather(lg.to_local(), part.spec_of(lg), mesh))
    return out


def train_cases(rank, world, inputs_path, cases, opt_kw):
    """Each case: (name, arch, mesh shape, dtype, config overrides, FSDP
    min_dim or None); one sharded even train step under ``set_mesh`` on
    DTensor parameters and moments (ZeRO-1), the parameters gathered whole
    and the loss."""
    import torch

    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import param_shapes
    from repro_torch.optim import adamw
    from repro_torch.sharding import P, set_mesh
    from repro_torch.sharding import partition as part
    from repro_torch.sharding.manual import gather
    from repro_torch.train.train_step import make_train_step

    z = np.load(inputs_path)
    out = {}
    for name, arch, shape, dtype, overrides, fsdp_min_dim in cases:
        cfg = _case_cfg(arch, dtype, overrides)
        dt = getattr(torch, dtype)
        mesh = _mesh(shape)
        params = _cast(params_from_numpy(_tree_from_npz(z, f"{arch}/params"), device="cpu"), dt)
        specs = _specs(cfg, mesh, fsdp_min_dim)
        opt = adamw.init(params)
        ospecs = adamw.opt_state_specs(specs, param_shapes(cfg), mesh)
        o_d = adamw.AdamWState(step=part.distribute(opt.step, P(), mesh),
                               mu=part.distribute(opt.mu, ospecs.mu, mesh),
                               nu=part.distribute(opt.nu, ospecs.nu, mesh))
        p_d = part.distribute(params, specs, mesh)
        batch = _batch(z, f"{arch}/train", dt)
        with set_mesh(mesh):
            p_d, o_d, metrics = make_train_step(cfg, adamw.AdamWConfig(**opt_kw))(p_d, o_d,
                                                                                 batch)
        for path, t in adamw.leaves(p_d):
            out[f"{name}/params/{path}"] = _f32(gather(t.to_local(), part.spec_of(t), mesh))
        out[f"{name}/loss"] = _f32(metrics["loss"])
        out[f"{name}/step"] = np.asarray(int(o_d.step.to_local()))
    return out


def all_checks(rank, world, inputs_path, decode, moe_list, counts, opt_kw, perm, specs,
               prefill=(), train=()):
    """Every program above in one process group (one spawn per test file)."""
    out = prefill_cases(rank, world, inputs_path, prefill)
    out.update(train_cases(rank, world, inputs_path, train, opt_kw))
    out.update(decode_cases(rank, world, inputs_path, decode))
    out.update(moe_cases(rank, world, inputs_path, moe_list))
    out.update({f"adaptive/{k}": v for k, v in
                adaptive_step(rank, world, inputs_path, counts, opt_kw).items()})
    out.update(remap(rank, world, perm))
    out.update(distribute_matches_dtensor(rank, world, specs))
    return out


def two_rank_step(rank, world):
    """One adaptive step of falcon-demo smoke over (data 2, model 1) on the
    port's own initial weights; the loss."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_adaptive_train_step

    cfg = get_config("falcon-demo-100m").smoke()
    data = DataConfig(seq_len=16, global_batch=4, slots=2, dp_groups=2)
    import torch

    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg, data, 0).items()}
    params = init_params(cfg, 0, device="cpu")
    step = make_adaptive_train_step(cfg, adamw.AdamWConfig(), _mesh((2, 1)))
    _, _, metrics = step(params, adamw.init(params), batch, [2, 1])
    return {"loss": _f32(metrics["loss"])}
