"""The port's mesh code on 4 gloo ranks (CPU) against the JAX package.

One spawn of 4 ranks (``tests/_torch_mesh_workers.py``, ``file://``
rendezvous under the test's temp dir, a timeout on every wait) runs every
torch-side program; one JAX subprocess with 8 forced host devices runs the
reference's mesh programs; the unsharded JAX decode runs in this process.
All three start from the same numpy inputs (the JAX package's initial
parameters, carried over as float32).

* Sharded decode (``make_decode_step`` under ``set_mesh``) on granite-3-8b
  smoke (KV heads sharded over ``model``) and granite-20b smoke (kv 1: the
  cache sequence sharded over ``model``, and at batch 1 folded over
  ``(data, model)``), plain and kernel routes, and on the other layer
  kinds (an expert-parallel MoE, an MoE sharded on its hidden dim, padded
  experts with a shared expert, Mamba2 in a hybrid, audio codebooks), two
  steps each: logits and
  caches against JAX's unsharded ``make_decode_step``. float32: 1e-4, the
  port's float32 tolerance against JAX (``tests/test_torch_serve.py``);
  bfloat16: the reference's 2e-2 (``tests/test_sharded_decode.py``).
  Against the port's own unsharded step in float32: 1e-5 relative, where
  only the all-reduce order differs.
* Expert-parallel MoE (olmoe smoke, float32) against JAX's EP run under
  ``set_mesh`` on 4 devices, at ``capacity_factor`` 8 (no drops), at the
  default, at 0.5 (per-shard capacity: the EP path drops what JAX's EP path
  drops, which is not what the local dispatch drops) and at batch 1
  (manual over ``model`` only): 1e-4.
* The adaptive S2 step (falcon-demo smoke, float32, counts [4, 2]) against
  JAX's ``make_adaptive_train_step`` and the one-process weighted step.
  AdamW runs with ``eps`` 1: at step 1 Adam's update is lr * sign(g)
  wherever |g| >> eps, so a gradient within rounding of 0 would move a
  parameter by +-lr on rounding alone; with eps 1 the update is linear in g
  and the parameters are held to 1e-5 relative.
* ``remap_mesh``: each rank's new coordinate is where JAX's ``remap_mesh``
  puts its device. ``distribute``'s shards equal JAX's
  ``devices_indices_map`` and DTensor's ``distribute_tensor``.
* The sharded prefill (``make_prefill_step`` under ``set_mesh``): logits
  and every cache leaf against JAX's unsharded ``make_prefill_step`` on
  granite-3-8b (heads; at batch 1 the prompt's sequence split over
  ``data``, gathered), granite-20b (kv 1: caches out with the sequence
  sharded over ``model``, grown, and one sharded decode step continuing
  from them), olmoe (expert-parallel over (1, 4)), jamba (placed by
  ``fsdp_param_specs`` at ``min_dim`` 64, so weights shard over ``data``;
  capacity factor 8 so that the per-shard capacity drops nothing), musicgen
  (codebooks) and qwen2-vl (embeds and M-RoPE).
* The sharded even train step (``make_train_step`` under ``set_mesh``, DTensor
  parameters and ZeRO-1 moments): the loss and every parameter after one
  step against JAX's unsharded ``make_train_step`` on the same six configs
  (jamba's MoE sharded on its hidden dim: the expert-parallel aux loss is
  the mean of the data shards', the reference's under a mesh, not the
  unsharded step's), AdamW ``eps`` 1 as above. Tolerances as for the
  decode: 1e-4 in float32, 2e-2 in bfloat16, 1e-5 against the port's own
  unsharded steps (relative; absolute 1e-5 for the prefill, 1e-7 for the
  parameters). One step moves a smoke weight by ~1e-5, inside those
  tolerances, so in float32 each leaf's change (after less start) is also
  held to the wanted change within 1e-4 of the latter's norm; the port's
  step on the first slot alone, a control, must miss that against JAX.
"""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_workers as workers
from repro.configs import base as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.schema import init_tree
from repro.serve.serve_step import make_decode_step as jmake_decode_step
from repro_torch.configs import base as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.serve.serve_step import make_decode_step as tmake_decode_step
from repro_torch.sharding import P
from repro_torch.sharding import partition as tpart

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
B, S = 4, 32
POSITIONS = (20, 21)    # slices of 8 (4-way) or 16 (2-way): full, partial and empty ones
COUNTS = [4, 2]
OPT = dict(lr=1e-2, eps=1.0, warmup_steps=0)
PERM = [2, 0, 3, 1]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SELF_TOL = dict(rtol=1e-5, atol=1e-6)
#: the sharded prefill against the port's unsharded one: its Mamba2 blocks
#: also sum the out-projection and the out-norm's mean square over ranks
#: (jamba smoke: 14 of them), ~1e-6 in logits of ~1e-2
PREFILL_SELF_TOL = dict(rtol=1e-5, atol=1e-5)
#: a float32 train step's change of each leaf (after less start) against
#: the wanted change, relative to the norm of the latter: one step moves a
#: smoke weight by ~1e-5, far inside the parameters' own tolerances, so the
#: change itself is held (bfloat16 rounds most of it away: no such check)
STEP_RTOL = 1e-4
#: (name, arch, mesh, batch, seq_shard, use_kernel, dtype, config overrides)
DECODE = [
    ("g8-2x2", "granite-3-8b", (2, 2), B, True, False, "float32", {}),
    ("g8-2x2-kernel", "granite-3-8b", (2, 2), B, True, True, "float32", {}),
    ("g8-1x4", "granite-3-8b", (1, 4), B, True, False, "float32", {}),
    ("g8-2x2-bf16", "granite-3-8b", (2, 2), B, True, False, "bfloat16", {}),
    ("g20-2x2", "granite-20b", (2, 2), B, True, False, "float32", {}),
    ("g20-2x2-kernel", "granite-20b", (2, 2), B, True, True, "float32", {}),
    ("g20-2x2-b1-fold", "granite-20b", (2, 2), 1, True, False, "float32", {}),
    ("g20-2x2-b1-fold-kernel", "granite-20b", (2, 2), 1, True, True, "float32", {}),
    ("g20-2x2-no-seq-shard", "granite-20b", (2, 2), B, False, False, "float32", {}),
    ("g20-2x2-bf16", "granite-20b", (2, 2), B, True, False, "bfloat16", {}),
    # The other layer kinds under a mesh. Over (1, 4) the expert-parallel
    # MoE sees all tokens, so its capacity is the unsharded one.
    ("olmoe-1x4-kernel", "olmoe-1b-7b", (1, 4), B, True, True, "float32", {}),
    ("olmoe-ff-2x2", "olmoe-1b-7b", (2, 2), B, True, False, "float32", {"moe_shard": "ff"}),
    ("qwen2-moe-1x4", "qwen2-moe-a2.7b", (1, 4), B, True, False, "float32", {}),
    ("jamba-1x4", "jamba-1.5-large-398b", (1, 4), B, True, False, "float32", {}),
    ("musicgen-2x2", "musicgen-large", (2, 2), B, True, False, "float32", {}),
]
S_PROMPT, GROW = 16, 8
#: (name, arch, mesh, dtype, config overrides, FSDP min_dim or None,
#: seq_shard, positions to grow the caches by and decode one step (0: none),
#: batch: at 1 the prompt's sequence is split over data and gathered)
PREFILL = [
    ("pf-g8-2x2", "granite-3-8b", (2, 2), "float32", {}, None, True, 0, B),
    ("pf-g8-2x2-bf16", "granite-3-8b", (2, 2), "bfloat16", {}, None, True, 0, B),
    ("pf-g20-2x2", "granite-20b", (2, 2), "float32", {}, None, True, GROW, B),
    ("pf-g8-2x2-b1", "granite-3-8b", (2, 2), "float32", {}, None, True, GROW, 1),
    ("pf-g20-2x2-no-seq-shard", "granite-20b", (2, 2), "float32", {}, None, False, GROW, B),
    ("pf-olmoe-1x4", "olmoe-1b-7b", (1, 4), "float32", {}, None, True, 0, B),
    ("pf-jamba-fsdp-2x2", "jamba-1.5-large-398b", (2, 2), "float32", {"capacity_factor": 8.0},
     64, True, GROW, B),
    ("pf-musicgen-2x2", "musicgen-large", (2, 2), "float32", {}, None, True, 0, B),
    ("pf-qwen2vl-2x2", "qwen2-vl-72b", (2, 2), "float32", {}, None, True, 0, B),
]
#: (name, arch, mesh, dtype, config overrides, FSDP min_dim or None)
TRAIN = [
    ("tr-g8-2x2", "granite-3-8b", (2, 2), "float32", {}, None),
    ("tr-g8-2x2-bf16", "granite-3-8b", (2, 2), "bfloat16", {}, None),
    ("tr-g20-2x2", "granite-20b", (2, 2), "float32", {}, None),
    ("tr-olmoe-1x4", "olmoe-1b-7b", (1, 4), "float32", {}, None),
    ("tr-jamba-fsdp-2x2", "jamba-1.5-large-398b", (2, 2), "float32", {"moe_shard": "ff"}, 64),
    ("tr-musicgen-2x2", "musicgen-large", (2, 2), "float32", {}, None),
    ("tr-qwen2vl-2x2", "qwen2-vl-72b", (2, 2), "float32", {}, None),
]
TRAIN_DATA = dict(seq_len=16, global_batch=8, slots=2, dp_groups=2)
ARCHS = sorted({c[1] for c in DECODE} | {c[1] for c in PREFILL} | {c[1] for c in TRAIN})
#: (name, capacity_factor (None = the config's), batch, seq, DTensor inputs)
MOE = [
    ("cf8", 8.0, 4, 16, False),
    ("cf8-dtensor", 8.0, 4, 16, True),
    ("default", None, 4, 16, False),
    ("cf0.5", 0.5, 4, 16, False),
    ("batch1", 8.0, 1, 1, False),
]
#: specs whose shards are held to JAX's index map on a (data 2, model 2) mesh
SPECS = [(("data", "model"), None, None), (None, ("data", "model"), None),
         ("model", "data", None), (None, None, "model"), ("data", None, None)]
SHAPE = (8, 4, 6)

JAX_SCRIPT = textwrap.dedent(r"""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    from dataclasses import replace
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import compat
    from repro.configs.base import get_config
    from repro.data.pipeline import DataConfig, make_batch
    from repro.models import moe
    from repro.optim import adamw
    from repro.train import train_step as ts
    from repro.train.trainer import remap_mesh

    inputs, out_path, args = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    z = np.load(inputs)
    def tree(prefix):
        out = {}
        for k in z.files:
            if k.startswith(prefix + "/"):
                node = out
                *parents, name = k[len(prefix) + 1:].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[name] = jnp.asarray(z[k])
        return out
    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
    out = {}

    # Expert-parallel MoE, float32.
    params, x_all = tree("moe/params"), jnp.asarray(z["moe/x"])
    for name, cf, b, s, _ in args["moe"]:
        cfg = replace(get_config("olmoe-1b-7b").smoke(), dtype="float32")
        if cf is not None:
            cfg = replace(cfg, capacity_factor=cf)
        x = x_all[:b, :s]
        f = jax.jit(lambda p, h: moe.apply_moe(p, h, cfg))
        out[name + "/dense_y"] = np.asarray(f(params, x)[0])
        with compat.set_mesh(mesh):
            y, aux = f(params, x)
        out[name + "/y"], out[name + "/aux"] = np.asarray(y), np.asarray(aux)

    # The adaptive S2 step, float32.
    cfg = replace(get_config("falcon-demo-100m").smoke(), dtype="float32")
    data = DataConfig(seq_len=32, global_batch=8, slots=4, dp_groups=2)
    batch = jax.tree.map(jnp.asarray, make_batch(cfg, data, 0))
    params = tree("train/params")
    with mesh:
        step = ts.make_adaptive_train_step(cfg, adamw.AdamWConfig(**args["opt"]), mesh)
        p2, _, m = jax.jit(step)(params, adamw.init(params), batch,
                                 jnp.asarray(args["counts"], jnp.int32))
    for path, leaf in jax.tree_util.tree_flatten_with_path(p2)[0]:
        out["adaptive/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    out["adaptive/loss"] = np.asarray(m["loss"])

    # remap_mesh: the device at each position of the new mesh.
    new = remap_mesh(mesh, args["perm"])
    out["remap"] = np.asarray([[d.id for d in row] for row in new.devices])

    # Each device's index into a sharded (8, 4, 6) array.
    for i, spec in enumerate(args["specs"]):
        sh = NamedSharding(mesh, P(*[tuple(e) if isinstance(e, list) else e for e in spec]))
        idx = sh.devices_indices_map(tuple(args["shape"]))
        out[f"index{i}"] = np.asarray(
            [[(s.start or 0, s.stop if s.stop is not None else n)
              for s, n in zip(idx[d], args["shape"])] for d in devs])
    np.savez(out_path, **out)
    print("JAX-MESH-OK")
""")


def f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def flat_np(tree, prefix):
    return {f"{prefix}/{'/'.join(k.key for k in path)}": np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def make_inputs(path):
    rng = np.random.default_rng(0)
    arrays = {}
    for arch in ARCHS:
        cfg = jconfigs.get_config(arch).smoke()
        arrays.update(flat_np(jmodel.init_params(cfg, 0), f"{arch}/params"))
        for k, leaves in jax.tree.map(lambda a: a.shape, jtransformer.init_caches(cfg, B, S)).items():
            for n, shape in leaves.items():
                arrays[f"{arch}/caches/{k}/{n}"] = rng.normal(size=shape).astype(np.float32)
        extra = (cfg.num_codebooks,) if cfg.modality == "audio_codes" else ()
        arrays[f"{arch}/tokens"] = rng.integers(0, cfg.vocab_size, (len(POSITIONS), B, 1, *extra))
        arrays[f"{arch}/positions"] = np.asarray(POSITIONS)
        arrays[f"{arch}/seq_len"] = np.asarray(S)
    from repro.data.pipeline import DataConfig, make_batch

    for arch in sorted({c[1] for c in PREFILL} | {c[1] for c in TRAIN}):
        cfg = jconfigs.get_config(arch).smoke()
        if cfg.modality == "vision_embeds":
            arrays[f"{arch}/prompt/embeds"] = rng.normal(
                size=(B, S_PROMPT, cfg.d_model)).astype(np.float32)
            arrays[f"{arch}/prompt/positions"] = rng.integers(0, S_PROMPT, (3, B, S_PROMPT))
            arrays[f"{arch}/next"] = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        else:
            extra = (cfg.num_codebooks,) if cfg.modality == "audio_codes" else ()
            arrays[f"{arch}/prompt/tokens"] = rng.integers(0, cfg.vocab_size,
                                                           (B, S_PROMPT, *extra))
            arrays[f"{arch}/next"] = rng.integers(0, cfg.vocab_size, (B, 1, *extra))
        for k, v in make_batch(cfg, DataConfig(**TRAIN_DATA), 0).items():
            arrays[f"{arch}/train/{k}"] = v
    cfg = jconfigs.get_config("olmoe-1b-7b").smoke()
    arrays.update(flat_np(init_tree(jmoe.moe_schema(cfg), jax.random.key(0)), "moe/params"))
    arrays["moe/x"] = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    cfg = jconfigs.get_config("falcon-demo-100m").smoke()
    arrays.update(flat_np(jmodel.init_params(cfg, 0), "train/params"))
    np.savez(path, **arrays)
    return np.load(path)


def decode_with_jax(z, name, arch, b, dtype, overrides):
    cfg = replace(jconfigs.get_config(arch).smoke(), dtype=dtype, **overrides)
    params = jax.tree.map(lambda a: jnp.asarray(a, cfg.activation_dtype), _tree(z, f"{arch}/params"))
    caches = jax.tree.map(lambda a: jnp.asarray(a[:, :b], cfg.activation_dtype),
                          _tree(z, f"{arch}/caches"))
    step = jax.jit(jmake_decode_step(cfg, S))
    out = {}
    for i, pos in enumerate(POSITIONS):
        tok = jnp.asarray(z[f"{arch}/tokens"][i, :b], jnp.int32)
        logits, caches = step(params, tok, caches, jnp.asarray(pos, jnp.int32))
        out[f"logits{i}"] = np.asarray(logits, np.float32)
    for k, c in caches.items():
        for n, t in c.items():
            out[f"caches/{k}/{n}"] = np.asarray(t, np.float32)
    return out


def decode_with_port(z, arch, b, use_kernel, overrides):
    cfg = replace(tconfigs.get_config(arch).smoke(), dtype="float32", **overrides)
    params = params_from_numpy(_tree(z, f"{arch}/params"), "cpu")
    caches = {k: {n: torch.as_tensor(a[:, :b]) for n, a in c.items()}
              for k, c in _tree(z, f"{arch}/caches").items()}
    step = tmake_decode_step(cfg, S, use_kernel=use_kernel)
    out = {}
    with torch.no_grad():
        for i, pos in enumerate(POSITIONS):
            logits, caches = step(params, torch.as_tensor(z[f"{arch}/tokens"][i, :b]),
                                  caches, pos)
            out[f"logits{i}"] = f32(logits)
    for k, c in caches.items():
        for n, t in c.items():
            out[f"caches/{k}/{n}"] = f32(t)
    return out


def _tree(z, prefix):
    return workers._tree_from_npz(z, prefix)


def _jax_batch(z, prefix, dt):
    return {k: jnp.asarray(v, dt) if k == "embeds" else jnp.asarray(v)
            for k, v in _tree(z, prefix).items()}


def _flat_caches(caches, cast):
    return {f"caches/{k}/{n}": cast(t) for k, c in caches.items() for n, t in c.items()}


def _prompt(tree, b):
    return {k: v[:, :b] if k == "positions" else v[:b] for k, v in tree.items()}


def prefill_with_jax(z, arch, dtype, overrides, grow, b):
    from repro.serve.serve_step import make_prefill_step

    cfg = replace(jconfigs.get_config(arch).smoke(), dtype=dtype, **overrides)
    dt = cfg.activation_dtype
    params = jax.tree.map(lambda a: jnp.asarray(a, dt), _tree(z, f"{arch}/params"))
    logits, caches = jax.jit(make_prefill_step(cfg, S_PROMPT))(
        params, _prompt(_jax_batch(z, f"{arch}/prompt", dt), b))
    out = {"logits": np.asarray(logits, np.float32),
           **_flat_caches(caches, lambda t: np.asarray(t, np.float32))}
    if grow:
        caches = jtransformer.grow_caches(caches, cfg, S_PROMPT + grow)
        tok = jnp.asarray(z[f"{arch}/next"][:b], dt if cfg.modality == "vision_embeds" else None)
        lg, _ = jax.jit(jmake_decode_step(cfg, S_PROMPT + grow))(
            params, tok, caches, jnp.asarray(S_PROMPT, jnp.int32))
        out["next_logits"] = np.asarray(lg, np.float32)
    return out


def prefill_with_port(z, arch, overrides, b):
    from repro_torch.serve.serve_step import make_prefill_step

    cfg = replace(tconfigs.get_config(arch).smoke(), dtype="float32", **overrides)
    params = params_from_numpy(_tree(z, f"{arch}/params"), "cpu")
    with torch.no_grad():
        logits, caches = make_prefill_step(cfg, S_PROMPT)(
            params, _prompt(workers._batch(z, f"{arch}/prompt", torch.float32), b))
    return {"logits": f32(logits), **_flat_caches(caches, f32)}


def train_with_jax(z, arch, dtype, overrides):
    from repro.optim import adamw as jadamw
    from repro.train.train_step import make_train_step

    cfg = replace(jconfigs.get_config(arch).smoke(), dtype=dtype, **overrides)
    dt = cfg.activation_dtype
    params = jax.tree.map(lambda a: jnp.asarray(a, dt), _tree(z, f"{arch}/params"))
    step = jax.jit(make_train_step(cfg, jadamw.AdamWConfig(**OPT)))
    p2, _, m = step(params, jadamw.init(params), _jax_batch(z, f"{arch}/train", dt))
    out = flat_np(p2, "params")
    out["loss"] = np.asarray(m["loss"], np.float32)
    return out


def train_with_port(z, arch, overrides, slots=None):
    """The port's unsharded step; with ``slots``, on the first ``slots``
    micro-batches only (a control that a check of the step must catch)."""
    from repro_torch.optim import adamw as tadamw
    from repro_torch.train.train_step import make_train_step

    cfg = replace(tconfigs.get_config(arch).smoke(), dtype="float32", **overrides)
    params = params_from_numpy(_tree(z, f"{arch}/params"), "cpu")
    batch = workers._batch(z, f"{arch}/train", torch.float32)
    if slots is not None:
        batch = {k: v if k == "positions" else v[:slots] for k, v in batch.items()}
    p2, _, m = make_train_step(cfg, tadamw.AdamWConfig(**OPT))(
        params, tadamw.init(params), batch)
    out = {f"params/{k}": f32(v) for k, v in tadamw.leaves(p2)}
    out["loss"] = f32(m["loss"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = str(tmp / "inputs.npz")
    z = make_inputs(inputs)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    args = {"moe": MOE, "opt": OPT, "counts": COUNTS, "perm": PERM, "specs": SPECS,
            "shape": SHAPE}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, inputs, str(tmp / "jax.npz"), json.dumps(args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = workers.spawn(workers.all_checks, 4, str(tmp / "ranks"), inputs, DECODE,
                              MOE, COUNTS, OPT, PERM, SPECS, PREFILL, TRAIN, timeout=300)
        jax_ref, by_key = {}, {}
        for name, arch, _, b, _, _, dtype, over in DECODE:   # one JAX run per model and batch
            key = (arch, b, dtype, tuple(sorted(over.items())))
            if key not in by_key:
                by_key[key] = decode_with_jax(z, name, arch, b, dtype, over)
            jax_ref[name] = by_key[key]
        port_ref = {name: decode_with_port(z, arch, b, kern, over)
                    for name, arch, _, b, _, kern, dtype, over in DECODE if dtype == "float32"}
        jax_prefill = {c[0]: prefill_with_jax(z, c[1], c[3], c[4], c[7], c[8])
                       for c in PREFILL}
        port_prefill = {c[0]: prefill_with_port(z, c[1], c[4], c[8]) for c in PREFILL
                        if c[3] == "float32"}
        jax_train = {c[0]: train_with_jax(z, c[1], c[3], c[4]) for c in TRAIN}
        port_train = {c[0]: train_with_port(z, c[1], c[4]) for c in TRAIN
                      if c[3] == "float32"}
        first_slot = {c[0]: train_with_port(z, c[1], c[4], slots=1) for c in TRAIN
                      if c[3] == "float32"}
        stdout, stderr = jax_proc.communicate(timeout=240)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0 and "JAX-MESH-OK" in stdout, stderr[-3000:]
    return {"ranks": ranks, "jax_decode": jax_ref, "port_decode": port_ref,
            "jax": dict(np.load(tmp / "jax.npz")), "inputs": z,
            "jax_prefill": jax_prefill, "port_prefill": port_prefill,
            "jax_train": jax_train, "port_train": port_train, "first_slot": first_slot}


@pytest.mark.parametrize("case", DECODE, ids=[c[0] for c in DECODE])
def test_sharded_decode_matches_jax(runs, case):
    name, arch, shape, b, seq_shard, use_kernel, dtype, _ = case
    got, want = runs["ranks"][0], runs["jax_decode"][name]
    for i in range(len(POSITIONS)):
        np.testing.assert_allclose(got[f"{name}/logits{i}"], want[f"logits{i}"], **TOL[dtype])
    for key in want:
        if key.startswith("caches/"):
            np.testing.assert_allclose(got[f"{name}/{key}"], want[key], **TOL[dtype])
    # every rank gathered the same whole values
    for other in runs["ranks"][1:]:
        np.testing.assert_array_equal(other[f"{name}/logits1"], got[f"{name}/logits1"])


@pytest.mark.parametrize("case", [c for c in DECODE if c[6] == "float32"],
                         ids=[c[0] for c in DECODE if c[6] == "float32"])
def test_sharded_decode_matches_unsharded_port(runs, case):
    name = case[0]
    got, want = runs["ranks"][0], runs["port_decode"][name]
    for key, value in want.items():
        np.testing.assert_allclose(got[f"{name}/{key}"], value, **SELF_TOL)


def test_sequence_sharded_cases_engage_the_fold():
    """The granite-20b cases shard the cache sequence over model, and at
    batch 1 over (data, model); granite-3-8b's shard the KV heads. The
    sharded decode refuses caches that are not DTensors (it updates their
    shards in place)."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), world_size=4, rank=0)
    try:
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        g20 = tconfigs.get_config("granite-20b").smoke()
        g8 = tconfigs.get_config("granite-3-8b").smoke()
        assert tpart.cache_specs(g20, mesh, B)["sub0"]["k"] == P(None, "data", "model", None, None)
        assert tpart.cache_specs(g20, mesh, 1)["sub0"]["k"] == P(None, None, ("data", "model"),
                                                                 None, None)
        assert tpart.cache_specs(g8, mesh, B)["sub0"]["k"] == P(None, "data", None, "model", None)
        from repro_torch.models import transformer
        from repro_torch.sharding import set_mesh

        caches = transformer.init_caches(g8, B, 8, device="cpu")
        with set_mesh(mesh), pytest.raises(TypeError, match="DTensors"):
            tmake_decode_step(g8, 8)({}, torch.zeros((B, 1), dtype=torch.long), caches, 0)
    finally:
        dist.destroy_process_group()


def test_expert_parallel_moe_refuses_autograd():
    """Its collectives carry no gradient: under autograd the EP path raises
    before it communicates."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models import moe as tmoe
    from repro_torch.models.schema import init_tree as tinit_tree
    from repro_torch.sharding import set_mesh

    dist.init_process_group("fake", store=FakeStore(), world_size=4, rank=0)
    try:
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        cfg = tconfigs.get_config("olmoe-1b-7b").smoke()
        params = tinit_tree(tmoe.moe_schema(cfg), 0, "cpu")
        x = torch.zeros((2, 3, cfg.d_model), requires_grad=True)
        with set_mesh(mesh), pytest.raises(RuntimeError, match="no gradient"):
            tmoe.apply_moe(params, x, cfg)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", MOE, ids=[c[0] for c in MOE])
def test_expert_parallel_moe_matches_jax(runs, case):
    name = case[0]
    got, want = runs["ranks"], runs["jax"]
    for rank in got:
        np.testing.assert_allclose(rank[f"{name}/y"], want[f"{name}/y"], **TOL["float32"])
        np.testing.assert_allclose(rank[f"{name}/aux"], want[f"{name}/aux"], rtol=1e-5)
    # the local dispatch of the port is the reference's dense-host path
    np.testing.assert_allclose(got[0][f"{name}/y_local"], want[f"{name}/dense_y"],
                               **TOL["float32"])


def test_expert_parallel_drops_what_jax_expert_parallel_drops(runs):
    """At capacity factor 0.5 the per-shard capacity drops other tokens than
    the dense dispatch drops: the EP output parts from the dense one in both
    packages, and the port's EP equals JAX's EP (the test above). (At the
    default 1.25 these 64 tokens overflow no expert in either dispatch.)"""
    got, want = runs["ranks"][0], runs["jax"]
    gap = np.abs(want["cf0.5/y"] - want["cf0.5/dense_y"]).max()
    assert gap > 1e-2, gap
    assert np.abs(got["cf0.5/y"] - got["cf0.5/y_local"]).max() > 1e-2
    # with no drops EP and dense agree
    np.testing.assert_allclose(want["cf8/y"], want["cf8/dense_y"], **TOL["float32"])


def test_adaptive_step_matches_jax(runs):
    got, want = runs["ranks"], runs["jax"]
    for rank in got:
        np.testing.assert_allclose(rank["adaptive/loss"], want["adaptive/loss"], rtol=1e-5)
        keys = [k for k in want if k.startswith("adaptive/") and k != "adaptive/loss"]
        assert keys and len(keys) == sum(k.startswith("adaptive/params/") for k in rank)
        for k in keys:
            name = k.removeprefix("adaptive/")
            np.testing.assert_allclose(rank[f"adaptive/params/{name}"], want[k],
                                       rtol=1e-5, atol=1e-7, err_msg=name)


def test_adaptive_step_is_the_weighted_one_process_step(runs):
    got = runs["ranks"][0]
    z = runs["inputs"]
    moved = 0
    for k in got:
        if k.startswith("adaptive/one/"):
            name = k.removeprefix("adaptive/one/")
            np.testing.assert_allclose(got[f"adaptive/params/{name}"], got[k],
                                       rtol=1e-5, atol=1e-7, err_msg=name)
            moved += not np.array_equal(got[k], z[f"train/params/{name}"])
    assert moved > 0
    np.testing.assert_allclose(got["adaptive/loss"], got["adaptive/one_loss"], rtol=1e-5)


def test_remap_mesh_moves_ranks_as_jax_moves_devices(runs):
    want = runs["jax"]["remap"]          # the device id at each new position
    for rank, res in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(res["new_ranks"], want)
        pos = tuple(int(i) for i in np.argwhere(want == rank)[0])
        assert tuple(res["new_coord"]) == pos
        assert tuple(res["coord"]) == divmod(rank, 2)


def test_shards_match_jax_index_map_and_dtensor(runs):
    want = runs["jax"]
    sizes = {"data": 2, "model": 2}
    for i, spec in enumerate(SPECS):
        for rank in range(4):
            sl = tpart.shard_slices(SHAPE, P(*spec), sizes, dict(zip(sizes, divmod(rank, 2))))
            assert [(s.start, s.stop) for s in sl] == [tuple(r) for r in want[f"index{i}"][rank]]
    for res in runs["ranks"]:
        assert res["same"].tolist() == [True] * len(SPECS)


def test_no_rank_loads_jax_or_the_reference(runs):
    for res in runs["ranks"]:
        assert res["modules"].size == 0, res["modules"][:5]


@pytest.mark.parametrize("case", PREFILL, ids=[c[0] for c in PREFILL])
def test_sharded_prefill_matches_jax(runs, case):
    name, dtype = case[0], case[3]
    got, want = runs["ranks"][0], runs["jax_prefill"][name]
    assert set(want) <= {k.removeprefix(name + "/") for k in got}
    for key, value in want.items():
        np.testing.assert_allclose(got[f"{name}/{key}"], value, **TOL[dtype], err_msg=key)
    for other in runs["ranks"][1:]:
        np.testing.assert_array_equal(other[f"{name}/logits"], got[f"{name}/logits"])


@pytest.mark.parametrize("case", [c for c in PREFILL if c[3] == "float32"],
                         ids=[c[0] for c in PREFILL if c[3] == "float32"])
def test_sharded_prefill_matches_unsharded_port(runs, case):
    name = case[0]
    got = runs["ranks"][0]
    for key, value in runs["port_prefill"][name].items():
        np.testing.assert_allclose(got[f"{name}/{key}"], value, **PREFILL_SELF_TOL,
                                   err_msg=key)


def test_prefill_cases_engage_their_layouts():
    """granite-20b's prefill caches come out with the sequence split over
    model (kv 1) or, without seq_shard, replicated over it; jamba's
    parameters at min_dim 64 split weights over data."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), world_size=4, rank=0)
    try:
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        g20 = tconfigs.get_config("granite-20b").smoke()
        assert tpart.cache_specs(g20, mesh, B)["sub0"]["k"][2] == "model"
        assert tpart.cache_specs(g20, mesh, B, seq_shard=False)["sub0"]["k"][2] is None
        jamba = tconfigs.get_config("jamba-1.5-large-398b").smoke()
        specs = [s for _, s in _flat_specs(tpart.fsdp_param_specs(jamba, mesh, min_dim=64))]
        assert any("data" in tpart.spec_axes(e) for s in specs for e in s)
    finally:
        dist.destroy_process_group()


def _flat_specs(tree, prefix=""):
    if isinstance(tree, P):
        return [(prefix, tree)]
    return [x for k, v in tree.items() for x in _flat_specs(v, f"{prefix}/{k}")]


def _step_err(got, want, start):
    """The largest, over leaves, of |(got - start) - (want - start)| /
    |want - start| (Frobenius norms, float64): how far a step's change of the
    parameters is from the wanted change."""
    worst = 0.0
    for k, w in want.items():
        w, g, s0 = (np.asarray(a, np.float64) for a in (w, got[k], start[k]))
        worst = max(worst, float(np.linalg.norm(g - w) / max(np.linalg.norm(w - s0), 1e-300)))
    return worst


@pytest.mark.parametrize("case", TRAIN, ids=[c[0] for c in TRAIN])
def test_sharded_train_step_matches_jax(runs, case):
    name, arch, dtype = case[0], case[1], case[3]
    got, want = runs["ranks"], runs["jax_train"][name]
    keys = [k for k in want if k.startswith("params/")]
    assert keys and len(keys) == sum(k.startswith(f"{name}/params/") for k in got[0])
    start = {k: runs["inputs"][f"{arch}/{k}"] for k in keys}
    for rank in got:
        np.testing.assert_allclose(rank[f"{name}/loss"], want["loss"], **TOL[dtype])
        assert int(rank[f"{name}/step"]) == 1
        for k in keys:
            np.testing.assert_allclose(rank[f"{name}/{k}"], want[k], **TOL[dtype], err_msg=k)
        if dtype == "float32":
            mine = {k: rank[f"{name}/{k}"] for k in keys}
            err = _step_err(mine, {k: want[k] for k in keys}, start)
            assert err <= STEP_RTOL, f"the step's change is {err:.3e} off JAX's"
    if dtype == "float32":
        # The control: the first slot's step alone must miss the bound.
        control = _step_err(runs["first_slot"][name], {k: want[k] for k in keys}, start)
        assert control > STEP_RTOL, f"the first slot's step is only {control:.3e} off"


@pytest.mark.parametrize("case", [c for c in TRAIN if c[3] == "float32"],
                         ids=[c[0] for c in TRAIN if c[3] == "float32"])
def test_sharded_train_step_matches_unsharded_port(runs, case):
    name = case[0]
    got, want = runs["ranks"][0], runs["port_train"][name]
    z = runs["inputs"]
    moved = 0
    for key, value in want.items():
        np.testing.assert_allclose(got[f"{name}/{key}"], value, rtol=1e-5, atol=1e-7,
                                   err_msg=key)
        if key.startswith("params/"):
            start = z[f"{case[1]}/{key}"]
            moved += not np.array_equal(got[f"{name}/{key}"], start)
    assert moved > 0
    keys = [k for k in want if k.startswith("params/")]
    err = _step_err({k: got[f"{name}/{k}"] for k in keys}, {k: want[k] for k in keys},
                    {k: z[f"{case[1]}/{k}"] for k in keys})
    assert err <= STEP_RTOL, f"the step's change is {err:.3e} off the unsharded step's"
