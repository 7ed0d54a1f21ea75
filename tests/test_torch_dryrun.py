"""The dry-run twin (``repro_torch.launch.dryrun``) against the JAX package's
(``repro.launch.dryrun``).

The JAX side runs in one subprocess: importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` for 512 host devices. The torch side builds its meshes on a
fake process group of 512 ranks that a module fixture makes and destroys.

* ``input_specs``: shapes and types equal the reference's
  ``ShapeDtypeStruct`` trees for the 10 archs x 4 shapes x dp 16 and 32.
* Per-device argument bytes: rank 0's local arguments (``lower_one`` on
  meta tensors) equal, for all 80 combinations, the sum over the
  reference's ``lower_one`` arguments of ``NamedSharding(mesh, spec).
  shard_shape(shape)`` x item size (the decode's ``pos`` scalar left out:
  the port's is a host int and XLA leaves it out too); and XLA's compiled
  ``argument_size_in_bytes`` on granite-3-8b train_4k and prefill_32k over
  16x16 (1,309,616,132 and 1,047,535,616).
* The ``--device cpu`` route (FakeTensorMode, MemTracker) at full width on
  combinations that JAX's own dry-run fails on (an attention arch's decode;
  an MoE prefill) writes the reference's keys, operations at least 0.9 x
  the model's per device.
* The CLI: an explicit ``--arch falcon-demo-100m`` runs (the reference
  skips it silently); ``--all`` leaves it out; nothing lands under
  ``results/``; a failing combination (an out-of-memory, as the card
  raises it) prints ``FAIL`` and makes the exit status 1; without a card
  the default route refuses to run.
* The whole 80-combination sweep on the CPU route, one case per arch, is
  ``slow``.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs.base import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCHS = [a for a in list_archs() if a != "falcon-demo-100m"]
SHAPES = list(INPUT_SHAPES)
COMBOS = [(a, s, mp) for a in ARCHS for s in SHAPES for mp in (False, True)]
XLA_ARGUMENT_BYTES = {("granite-3-8b", "train_4k"): 1_309_616_132,
                      ("granite-3-8b", "prefill_32k"): 1_047_535_616}

JAX_SCRIPT = textwrap.dedent(r"""
    import json, sys
    import numpy as np
    from repro.launch import dryrun as d          # sets XLA_FLAGS: first
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import INPUT_SHAPES, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.models import model as model_lib
    from repro.optim import adamw
    from repro.sharding import partition

    combos, compiles = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    out = {"specs": {}, "bytes": {}, "xla": {}}
    for arch in sorted({c[0] for c in combos}):
        cfg = get_config(arch)
        for shape in INPUT_SHAPES:
            for dp in (16, 32):
                leaves = jax.tree_util.tree_flatten_with_path(d.input_specs(cfg, shape, dp))[0]
                out["specs"][f"{arch}|{shape}|{dp}"] = {
                    "/".join(str(getattr(k, "key", k)) for k in path):
                    [list(x.shape), str(x.dtype)] for path, x in leaves}

    def total(mesh, shapes, specs):
        is_p = lambda x: isinstance(x, P)
        sh, sp = jax.tree.leaves(shapes), jax.tree.leaves(specs, is_leaf=is_p)
        assert len(sh) == len(sp)
        return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(x.shape)))
                   * jnp.dtype(x.dtype).itemsize for x, s in zip(sh, sp))

    meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}
    for arch, shape, mp in combos:
        mesh, cfg = meshes[mp], get_config(arch)
        info = INPUT_SHAPES[shape]
        dp = partition.mesh_axis_size(mesh, partition.batch_axes(mesh))
        pspecs = partition.param_specs(cfg, mesh)
        tp = partition.mesh_axis_size(mesh, "model")
        if d.SEQ_SHARD_CACHES and cfg.total_params() * 2 / max(tp, 1) > d.FSDP_SERVE_BYTES:
            pspecs = partition.fsdp_param_specs(cfg, mesh)
        pshapes = model_lib.param_shapes(cfg)
        batch = d.input_specs(cfg, shape, dp)
        n = total(mesh, pshapes, pspecs)
        if info["kind"] == "train":
            opt = adamw.AdamWState(
                step=jax.ShapeDtypeStruct((), jnp.int32),
                mu=jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), pshapes),
                nu=jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), pshapes))
            n += total(mesh, opt, adamw.opt_state_specs(pspecs, pshapes, mesh))
            n += total(mesh, batch, partition.train_batch_specs(cfg, mesh))
        elif info["kind"] == "prefill":
            n += total(mesh, batch, partition.serve_batch_specs(cfg, mesh, info["global_batch"]))
        else:
            gb = info["global_batch"]
            n += total(mesh, batch["tokens"], partition.decode_token_specs(cfg, mesh, gb))
            n += total(mesh, batch["caches"], partition.cache_specs(cfg, mesh, gb))
        out["bytes"][f"{arch}|{shape}|{int(mp)}"] = n
    for arch, shape in compiles:
        res = d.dryrun(arch, shape, False)
        out["xla"][f"{arch}|{shape}"] = res["bytes_per_device"]["argument"]
    print("JAX-DRYRUN-OK " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_side():
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(COMBOS),
         json.dumps([list(k) for k in XLA_ARGUMENT_BYTES])],
        env=env, capture_output=True, text=True, timeout=300)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("JAX-DRYRUN-OK ")]
    assert proc.returncode == 0 and line, proc.stderr[-3000:]
    return json.loads(line[0].removeprefix("JAX-DRYRUN-OK "))


@pytest.fixture(scope="module")
def fake_world():
    """A fake process group of 512 ranks (one process, rank 0), and the
    production meshes over its first 256 and all 512 ranks."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("fake", store=FakeStore(), world_size=512, rank=0)
    try:
        yield {False: DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                                 mesh_dim_names=("data", "model")),
               True: DeviceMesh("cpu", torch.arange(512).reshape(2, 16, 16),
                                mesh_dim_names=("pod", "data", "model"))}
    finally:
        if own:
            dist.destroy_process_group()


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: [list(tree.shape), str(tree.dtype).removeprefix("torch.")]}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(jax_side, arch):
    cfg = get_config(arch)
    for shape in SHAPES:
        for dp in (16, 32):
            got = _flat(dryrun.input_specs(cfg, shape, dp))
            assert all(t.device.type == "meta" for t in
                       torch.utils._pytree.tree_leaves(dryrun.input_specs(cfg, shape, dp)))
            assert got == jax_side["specs"][f"{arch}|{shape}|{dp}"], (shape, dp)


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_jax_shard_shape_sum(jax_side, fake_world, arch):
    for shape in SHAPES:
        for mp in (False, True):
            step, args = dryrun.lower_one(get_config(arch), shape, fake_world[mp], "meta")
            got = dryrun.local_bytes(args)
            assert got == jax_side["bytes"][f"{arch}|{shape}|{int(mp)}"], (shape, mp)
            if INPUT_SHAPES[shape]["kind"] == "decode":
                assert isinstance(args[-1], int)     # pos: a host int, no bytes


def test_argument_bytes_equal_xla_compiled_argument_size(jax_side, fake_world):
    for (arch, shape), want in XLA_ARGUMENT_BYTES.items():
        assert jax_side["xla"][f"{arch}|{shape}"] == want
        _, args = dryrun.lower_one(get_config(arch), shape, fake_world[False], "meta")
        assert dryrun.local_bytes(args) == want


REFERENCE_KEYS = {"arch", "shape", "mesh", "n_devices", "flops", "bytes_accessed",
                  "collective_bytes", "bytes_per_device", "lower_s", "compile_s"}


def _model_flops(arch, shape, n_devices):
    cfg, info = get_config(arch), INPUT_SHAPES[shape]
    tokens = info["global_batch"] * (1 if info["kind"] == "decode" else info["seq_len"])
    return (6.0 if info["kind"] == "train" else 2.0) * cfg.active_params() * tokens / n_devices


@pytest.mark.parametrize("arch,shape", [("granite-3-8b", "decode_32k"),
                                        ("olmoe-1b-7b", "prefill_32k")])
def test_cpu_route_at_full_width_writes_the_reference_keys(fake_world, arch, shape):
    """Both fail in JAX's dry-run on this JAX (the decode's
    dynamic_update_slice sharding, the MoE's scan carry); the twin runs them."""
    rec = dryrun.dryrun(arch, shape, False, "cpu")
    assert REFERENCE_KEYS <= set(rec) and rec["compile_s"] is None
    assert rec["device"] == "cpu (FakeTensorMode)" and rec["n_devices"] == 256
    assert set(rec["bytes_per_device"]) == {"argument", "output", "temp", "peak"}
    bpd = rec["bytes_per_device"]
    assert bpd["peak"] >= bpd["argument"] > 0 and bpd["output"] > 0
    assert rec["flops"] >= 0.9 * _model_flops(arch, shape, 256)
    assert rec["bytes_accessed"] > bpd["argument"]
    assert set(rec["collective_bytes"]) <= set(dryrun.COLLECTIVES)
    assert rec["collective_bytes"].get("all-reduce", 0) > 0


def test_all_leaves_out_falcon_demo_and_names_80_combinations():
    combos = dryrun.combinations(None, None, True, "both")
    assert len(combos) == 80 and not any(a == "falcon-demo-100m" for a, _, _ in combos)
    assert dryrun.combinations("falcon-demo-100m", None, False, "off") == [
        ("falcon-demo-100m", s, False) for s in SHAPES]


def _results_listing():
    out = []
    for root, _, files in os.walk(os.path.join(ROOT, "results")):
        out += [(os.path.join(root, f), os.path.getmtime(os.path.join(root, f)))
                for f in files]
    return sorted(out)


def _cli(args, cwd, timeout=300):
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_runs_an_explicit_falcon_demo_and_writes_only_to_out(tmp_path):
    before = _results_listing()
    out = tmp_path / "records"
    proc = _cli(["--arch", "falcon-demo-100m", "--shape", "decode_32k", "--device", "cpu",
                 "--out", str(out)], ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "OK falcon-demo-100m x decode_32k x 16x16" in proc.stdout
    assert "ALL DRY-RUNS PASSED" in proc.stdout
    rec = json.loads((out / "falcon-demo-100m__decode_32k__16_16.json").read_text())
    assert REFERENCE_KEYS <= set(rec)
    assert _results_listing() == before


def test_a_failing_combination_prints_fail_and_exits_1(monkeypatch, capsys):
    def out_of_memory(*args):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(dryrun, "dryrun", out_of_memory)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "falcon-demo-100m", "--shape", "decode_32k", "--device", "cpu"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL falcon-demo-100m x decode_32k x 16x16: OutOfMemoryError" in out
    assert "ALL DRY-RUNS PASSED" not in out


def test_cli_wants_the_card_by_default(tmp_path):
    assert _cli(["--arch", "no-such-arch", "--device", "cpu"], tmp_path).returncode != 0
    if not torch.cuda.is_available():
        proc = _cli(["--arch", "falcon-demo-100m", "--shape", "decode_32k"], tmp_path)
        assert proc.returncode != 0 and "--device cpu" in proc.stderr


#: the archs of ``--all``; one full-width ``--multi-pod both`` sweep of one
#: arch on the CPU route takes minutes to most of an hour on a CPU core
SWEEP_ARCHS = sorted({a for a, _, _ in dryrun.combinations(None, None, True, "both")})
SWEEP_TIMEOUT_S = 7200


@pytest.mark.slow
@pytest.mark.parametrize("arch", SWEEP_ARCHS)
def test_every_combination_runs_on_the_cpu_route(tmp_path, arch):
    proc = _cli(["--arch", arch, "--multi-pod", "both", "--device", "cpu", "--out",
                 str(tmp_path)], ROOT, timeout=SWEEP_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert len(list(tmp_path.glob("*.json"))) == 2 * len(SHAPES)
