"""Multi-pod dry-run — the twin of :mod:`repro.launch.dryrun`: every (arch x
input shape x mesh) combination's step, with the memory, operation and
collective counts that the roofline analysis reads.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
        --out build/repro_torch_results/dryrun [--device cpu]

Where the reference lowers and compiles each step with XLA on 256 or 512
forced host devices and reads XLA's memory and cost analyses and the
collectives of the compiled HLO, the twin runs the step once, in one
process, as rank 0 of the production mesh over a fake process group of 256
or 512 ranks (``torch.distributed``'s ``fake`` backend: collectives return
at once and move nothing). The steps are the port's sharded steps under
``set_mesh``: ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` with the reference's placements (``param_specs``, or
``fsdp_param_specs`` past ``FSDP_SERVE_BYTES``; ``opt_state_specs``; the
batch, token and cache specs).

Only rank 0's arguments are built, each leaf at its local shape (a full
jamba-1.5-large-398b parameter tree is 796 GB in bf16). Values after a fake
collective are whatever the receiving buffer held: nothing branches on them
or reads them back, and every shape is static (MoE capacity included), so
the counts are the real step's.

* **On the card** (the default): the local tensors are real, on the H100,
  and the step runs once under three recorders: ``FlopCounterMode`` gives
  ``flops`` (every matrix product, the rematerialised forward included);
  a dispatch mode summing each operation's input and output bytes gives
  ``bytes_accessed`` (eager and unfused: every intermediate counts, where
  XLA's estimate is of a fused program); :func:`repro_torch.sharding.manual.
  record_collectives` gives ``collective_bytes`` (each collective's result
  in the type it moved, float32 for bfloat16 tensors). ``bytes_per_device``:
  ``argument`` exact, from the local shapes (the decode's ``pos`` is a host
  int and counts nothing; XLA leaves its scalar out too); ``output`` the
  local bytes of the step's outputs; ``peak`` ``torch.cuda.
  max_memory_allocated`` over the step after a reset (the arguments
  included); ``temp`` = peak - argument - output, at least 0.
* **With ``--device cpu``**: the same step under ``FakeTensorMode`` (no
  storage is allocated); ``peak`` is
  ``torch.distributed._tools.mem_tracker.MemTracker``'s estimate.

The record keeps every key the reference writes. ``compile_s`` is null:
nothing compiles. ``lower_s`` is the seconds to build the step and rank 0's
arguments; ``step_s`` the seconds of the one run, recorders on (local
compute only: the fake collectives take no time; on the card,
synchronised). ``device`` names where it ran.

Not copied from the reference: every combination runs, the ones JAX cannot
lower or compile on its Explicit-axes mesh included; an explicit ``--arch
falcon-demo-100m`` runs (``--all`` still leaves it out); a combination that
fails, an out-of-memory on the card included, prints ``FAIL`` and makes the
exit status 1. Nothing is written unless ``--out`` names a directory.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, get_config, list_archs
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.serve import serve_step as serve_lib
from repro_torch.sharding import P, set_mesh
from repro_torch.sharding import partition
from repro_torch.sharding.manual import as_dtensor, record_collectives
from repro_torch.train import train_step as ts_lib

SLOTS = 8

#: the reference's collective names, in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: set False (--baseline-sharding) to reproduce the pre-optimization
#: replicated-KV-cache baseline (and no serve-time FSDP), as the reference.
SEQ_SHARD_CACHES = True

#: serve-time FSDP threshold: if the model-axis param shard alone exceeds
#: this, weights are additionally sharded over the DP axes (gathered at use).
FSDP_SERVE_BYTES = 12 * 2**30


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name: str, dp_groups: int) -> dict:
    """Meta-tensor stand-ins (shape and type, no storage) for every model
    input: the reference's ``ShapeDtypeStruct`` tree."""
    info = INPUT_SHAPES[shape_name]
    s, gb, kind = info["seq_len"], info["global_batch"], info["kind"]
    i32 = torch.int32
    act = cfg.activation_dtype

    if kind == "train":
        mb_seqs = max(1, gb // (dp_groups * SLOTS))
        gmb = dp_groups * mb_seqs
        if cfg.modality == "vision_embeds":
            return {
                "embeds": _meta((SLOTS, gmb, s, cfg.d_model), act),
                "positions": _meta((3, gmb, s), i32),
                "labels": _meta((SLOTS, gmb, s), i32),
            }
        if cfg.modality == "audio_codes":
            return {
                "tokens": _meta((SLOTS, gmb, s, cfg.num_codebooks), i32),
                "labels": _meta((SLOTS, gmb, s, cfg.num_codebooks), i32),
            }
        return {"tokens": _meta((SLOTS, gmb, s), i32), "labels": _meta((SLOTS, gmb, s), i32)}

    if kind == "prefill":
        if cfg.modality == "vision_embeds":
            return {"embeds": _meta((gb, s, cfg.d_model), act),
                    "positions": _meta((3, gb, s), i32)}
        if cfg.modality == "audio_codes":
            return {"tokens": _meta((gb, s, cfg.num_codebooks), i32)}
        return {"tokens": _meta((gb, s), i32)}

    # decode: one new token + caches of length s.
    if cfg.modality == "vision_embeds":
        tok = _meta((gb, 1, cfg.d_model), act)
    elif cfg.modality == "audio_codes":
        tok = _meta((gb, 1, cfg.num_codebooks), i32)
    else:
        tok = _meta((gb, 1), i32)
    caches = {key: {n: _meta(shape, dt) for n, (shape, dt) in leaves.items()}
              for key, leaves in transformer.cache_shapes(cfg, gb, s).items()}
    return {"tokens": tok, "caches": caches, "pos": _meta((), i32)}


def collective_bytes(record: dict) -> dict[str, float]:
    """``{collective name: bytes}`` of a :func:`record_collectives` record,
    in the reference's names and order (kinds that moved nothing left out,
    as the reference's HLO scan leaves them out)."""
    return {k: float(record[k]) for k in COLLECTIVES if record.get(k)}


# ------------------------------------------------------------- arguments
class _Leaves:
    """Rank 0's local tensors of each argument leaf, drawn on ``device``:
    floating leaves normal x 0.02, integer leaves below ``high``."""

    def __init__(self, mesh, device, seed: int = 0):
        self.mesh, self.device = mesh, torch.device(device)
        self.sizes = partition.axis_sizes(mesh)
        self.coord = partition.coordinate(mesh)
        self.gen = None
        if self.device.type == "cuda":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(seed)

    def local_shape(self, shape, spec: P) -> tuple[int, ...]:
        return tuple(sl.stop - sl.start for sl in
                     partition.shard_slices(shape, spec, self.sizes, self.coord))

    def one(self, shape, dtype, spec: P, high: int = 1):
        local = self.local_shape(shape, spec)
        if self.gen is None:           # meta or fake tensors: values do not matter
            t = torch.zeros(local, dtype=dtype, device=self.device)
        elif dtype.is_floating_point:
            t = torch.randn(local, generator=self.gen, device=self.device).mul_(0.02).to(dtype)
        else:
            t = torch.randint(0, max(high, 1), local, generator=self.gen, device=self.device,
                              dtype=dtype)
        return as_dtensor(t, spec, self.mesh, shape=shape)

    def tree(self, metas, specs, dtype=None, high: int = 1):
        if isinstance(metas, torch.Tensor):
            return self.one(metas.shape, dtype or metas.dtype, specs, high)
        return {k: self.tree(metas[k], specs[k], dtype, high) for k in metas}


def _batch_high(cfg: ArchConfig, key: str, seq_len: int) -> int:
    return seq_len if key == "positions" else cfg.vocab_size


def _param_specs(cfg: ArchConfig, mesh) -> dict:
    pspecs = partition.param_specs(cfg, mesh)
    if SEQ_SHARD_CACHES:
        tp = partition.mesh_axis_size(mesh, "model")
        resident = cfg.total_params() * 2 / max(tp, 1)
        if resident > FSDP_SERVE_BYTES:
            # Serve: weights gathered per period. Train: full FSDP — params,
            # grads and (via zero1) moments shard over the DP axes too.
            pspecs = partition.fsdp_param_specs(cfg, mesh)
    return pspecs


def lower_one(cfg: ArchConfig, shape_name: str, mesh, device) -> tuple:
    """The step and rank 0's arguments for one combination: ``(step,
    args)``, ``step(*args)`` to be called under ``set_mesh(mesh)``; every
    argument leaf a DTensor over its local tensor on ``device`` (``meta``
    for shapes only), but the decode's ``pos``, a host int."""
    info = INPUT_SHAPES[shape_name]
    kind, s, gb = info["kind"], info["seq_len"], info["global_batch"]
    dp = partition.mesh_axis_size(mesh, partition.batch_axes(mesh))
    pspecs = _param_specs(cfg, mesh)
    pshapes = model_lib.param_shapes(cfg)
    leaves = _Leaves(mesh, device)
    spec = input_specs(cfg, shape_name, dp)
    params = leaves.tree(pshapes, pspecs)

    if kind == "train":
        step = ts_lib.make_train_step(cfg, adamw.AdamWConfig())
        ospecs = adamw.opt_state_specs(pspecs, pshapes, mesh)
        opt = adamw.AdamWState(
            step=leaves.one((), torch.int32, P()),
            mu=leaves.tree(pshapes, ospecs.mu, torch.float32),
            nu=leaves.tree(pshapes, ospecs.nu, torch.float32))
        bspecs = partition.train_batch_specs(cfg, mesh)
        batch = {k: leaves.one(v.shape, v.dtype, bspecs[k], _batch_high(cfg, k, s))
                 for k, v in spec.items()}
        return step, (params, opt, batch)
    if kind == "prefill":
        step = serve_lib.make_prefill_step(cfg, s, seq_shard=SEQ_SHARD_CACHES)
        bspecs = partition.serve_batch_specs(cfg, mesh, gb)
        batch = {k: leaves.one(v.shape, v.dtype, bspecs[k], _batch_high(cfg, k, s))
                 for k, v in spec.items()}
        return step, (params, batch)
    step = serve_lib.make_decode_step(cfg, s)
    tok = leaves.one(spec["tokens"].shape, spec["tokens"].dtype,
                     partition.decode_token_specs(cfg, mesh, gb), cfg.vocab_size)
    caches = leaves.tree(spec["caches"],
                         partition.cache_specs(cfg, mesh, gb, seq_shard=SEQ_SHARD_CACHES))
    return step, (params, tok, caches, s - 1)


def local_bytes(tree) -> int:
    """The bytes of the local tensors of every DTensor or tensor leaf."""
    return sum(t.numel() * t.element_size() for t in _local_tensors(tree))


def _local_tensors(tree) -> list:
    """The local tensors of every DTensor or tensor leaf of nested dicts,
    tuples and lists (other leaves, such as a host int, left out)."""
    if isinstance(tree, (dict, tuple, list)):
        items = tree.values() if isinstance(tree, dict) else tree
        return [t for v in items for t in _local_tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.to_local() if hasattr(tree, "to_local") else tree]
    return []


class _BytesAccessed(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums the bytes of every operation's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
        self.total += sum(t.numel() * t.element_size() for t in flat
                          if isinstance(t, torch.Tensor))
        return out


# ------------------------------------------------------------- the mesh
@contextlib.contextmanager
def _production_mesh(multi_pod: bool, device_type: str):
    """The production mesh over a fake process group: the caller's group
    where one with enough ranks exists (rank 0 of it), else one made here
    and destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("fake", store=FakeStore(), world_size=need, rank=0)
    elif dist.get_world_size() < need or dist.get_rank() != 0:
        raise RuntimeError(f"the dry-run runs as rank 0 of {need} ranks; this process is "
                           f"rank {dist.get_rank()} of {dist.get_world_size()}")
    try:
        yield DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=names)
    finally:
        if own:
            dist.destroy_process_group()


def _resolve(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry-run runs on the card by default and there is none: "
                           "pass --device cpu for the FakeTensorMode estimate")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {device}: cuda or cpu")
    return dev


def dryrun(arch: str, shape_name: str, multi_pod: bool, device: str = "cuda") -> dict:
    """One combination's record (the module docstring lists its keys)."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = _resolve(device)
    cfg = get_config(arch)
    on_card = dev.type == "cuda"
    with _production_mesh(multi_pod, dev.type) as mesh, set_mesh(mesh):
        fake = contextlib.nullcontext()
        if not on_card:
            from torch._subclasses.fake_tensor import FakeTensorMode
            from torch.distributed._tools import fake_collectives  # noqa: F401  c10d fakes

            fake = FakeTensorMode()
        with fake:
            t0 = time.monotonic()
            step, args = lower_one(cfg, shape_name, mesh, dev)
            if on_card:
                torch.cuda.synchronize()
            t_lower = time.monotonic() - t0
            argument = local_bytes(args)
            flops, nbytes = FlopCounterMode(display=False), _BytesAccessed()
            tracker = contextlib.nullcontext()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            else:
                from torch.distributed._tools.mem_tracker import MemTracker

                tracker = MemTracker()
                tracker.track_external(*_local_tensors(args))
            t0 = time.monotonic()
            with record_collectives() as coll, tracker, flops, nbytes:
                out = step(*args)
            if on_card:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
            else:
                peak = tracker.get_tracker_snapshot("peak")[dev]["Total"]
            t_step = time.monotonic() - t0
            output = local_bytes(out)
        del out, args, step
    n_dev = math.prod(mesh.shape)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": int(n_dev),
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(nbytes.total),
        "collective_bytes": collective_bytes(coll),
        "bytes_per_device": {
            "argument": int(argument),
            "output": int(output),
            "temp": int(max(peak - argument - output, 0)),
            "peak": int(peak),
        },
        "lower_s": round(t_lower, 2),
        "compile_s": None,
        "step_s": round(t_step, 3),
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu (FakeTensorMode)",
    }


def combinations(arch, shape, run_all: bool, multi_pod: str) -> list[tuple[str, str, bool]]:
    """``(arch, shape, multi_pod)`` to run: ``--all`` takes every arch but
    falcon-demo-100m (as the reference), ``--arch`` the one named."""
    archs = [a for a in list_archs() if a != "falcon-demo-100m"] if run_all else [arch]
    archs = [a for a in archs if a]
    shapes = list(INPUT_SHAPES) if run_all or not shape else [shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[multi_pod]
    return [(a, s, mp) for a in archs for s in shapes for mp in pods]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    ap.add_argument(
        "--baseline-sharding", action="store_true",
        help="replicate the KV caches and leave serve-time FSDP off, as the reference",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (FakeTensorMode, no allocation)")
    args = ap.parse_args(argv)
    if args.baseline_sharding:
        global SEQ_SHARD_CACHES
        SEQ_SHARD_CACHES = False
    if not args.all and not args.arch:
        ap.error("name an --arch or pass --all")
    if args.arch:
        get_config(args.arch)        # an unknown arch fails here, before any run
    _resolve(args.device)

    failures = []
    for arch, shape_name, mp in combinations(args.arch, args.shape, args.all, args.multi_pod):
        tag = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
        try:
            res = dryrun(arch, shape_name, mp, args.device)
        except Exception as e:  # noqa: BLE001  a failed combination is reported, not fatal
            print(f"FAIL {tag}: {type(e).__name__}: {str(e).splitlines()[0][:300]}")
            traceback.print_exc()
            failures.append(tag)
            continue
        finally:
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        print(
            f"OK {tag}: flops={res['flops']:.3e} "
            f"peak/dev={res['bytes_per_device']['peak']/2**30:.2f}GiB "
            f"step={res['step_s']}s", flush=True,
        )
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fn = f"{arch}__{shape_name}__{res['mesh'].replace('x', '_')}.json"
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(res, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:\n" + "\n".join(failures))
        sys.exit(1)
    print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
