"""The port's sharding specs (``repro_torch.sharding.partition``,
``repro_torch.optim.adamw.{zero1_specs,opt_state_specs}``,
``repro_torch.models.model.{param_shapes,param_axes}``) against the JAX
package's, for all 11 configs on the meshes (1, 1), (2, 2), (16, 16) and
(2, 16, 16).

The JAX side resolves on a ``jax.sharding.AbstractMesh``; the torch side on
a DeviceMesh over a fake process group of 512 ranks (one process, no
devices, no communication). Every spec must be equal, entry for entry:
specs are exact, so there is no tolerance.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import base as jconfigs
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.sharding import partition as jpart
from repro_torch.configs import base as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import P, ambient_mesh, set_mesh
from repro_torch.sharding import partition as tpart

ARCHS = jconfigs.list_archs()
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
BATCHES = (1, 8, 128)
WORLD = 512


@pytest.fixture(scope="module")
def meshes():
    """name -> (JAX AbstractMesh, torch DeviceMesh) over a fake 512-rank
    process group, torn down after the module."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("fake", store=FakeStore(), world_size=WORLD, rank=0)
    try:
        out = {}
        for name, (shape, axes) in MESHES.items():
            n = int(np.prod(shape))
            out[name] = (AbstractMesh(shape, axes),
                         DeviceMesh("cpu", torch.arange(n).reshape(shape),
                                    mesh_dim_names=axes))
        yield out
    finally:
        if own:
            dist.destroy_process_group()


def norm(spec):
    """A JAX PartitionSpec or a port P as a plain tuple of entries."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)


def flat(tree, prefix=""):
    """``{path: spec tuple}`` of a nested dict of specs (either package)."""
    if not isinstance(tree, dict):
        return {prefix: norm(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}/{k}"))
    return out


def configs(arch):
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


CASES = [(a, m) for a in ARCHS for m in MESHES]


def test_mesh_builders_raise_without_a_process_group():
    """Runs before any test of this module makes the fake process group."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks; none is initialised"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="4 ranks; none is initialised"):
        tmesh.make_host_mesh(2, 2, device="cpu")


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_param_specs_match_jax(meshes, arch, mesh_name):
    jm, tm = meshes[mesh_name]
    cj, ct = configs(arch)
    want, got = flat(jpart.param_specs(cj, jm)), flat(tpart.param_specs(ct, tm))
    assert got == want
    assert all(isinstance(s, P) for s in _leaves(tpart.param_specs(ct, tm)))


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_fsdp_param_specs_match_jax(meshes, arch, mesh_name):
    jm, tm = meshes[mesh_name]
    cj, ct = configs(arch)
    assert flat(tpart.fsdp_param_specs(ct, tm)) == flat(jpart.fsdp_param_specs(cj, jm))
    # min_dim is honoured as in the reference
    assert (flat(tpart.fsdp_param_specs(ct, tm, min_dim=256))
            == flat(jpart.fsdp_param_specs(cj, jm, min_dim=256)))


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_batch_and_logits_specs_match_jax(meshes, arch, mesh_name):
    jm, tm = meshes[mesh_name]
    cj, ct = configs(arch)
    assert flat(tpart.train_batch_specs(ct, tm)) == flat(jpart.train_batch_specs(cj, jm))
    for b in BATCHES:
        assert (flat(tpart.serve_batch_specs(ct, tm, b))
                == flat(jpart.serve_batch_specs(cj, jm, b))), b
        assert norm(tpart.decode_token_specs(ct, tm, b)) == norm(
            jpart.decode_token_specs(cj, jm, b)), b
        assert norm(tpart.logits_spec(ct, tm, b)) == norm(jpart.logits_spec(cj, jm, b)), b


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq_shard", "no_seq_shard"])
@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_cache_specs_match_jax(meshes, arch, mesh_name, seq_shard):
    jm, tm = meshes[mesh_name]
    cj, ct = configs(arch)
    for b in BATCHES:
        assert (flat(tpart.cache_specs(ct, tm, b, seq_shard=seq_shard))
                == flat(jpart.cache_specs(cj, jm, b, seq_shard=seq_shard))), b


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_opt_state_specs_match_jax(meshes, arch, mesh_name):
    jm, tm = meshes[mesh_name]
    cj, ct = configs(arch)
    for fsdp in (False, True):
        jspecs = (jpart.fsdp_param_specs if fsdp else jpart.param_specs)(cj, jm)
        tspecs = (tpart.fsdp_param_specs if fsdp else tpart.param_specs)(ct, tm)
        want = jadamw.opt_state_specs(jspecs, jmodel.param_shapes(cj), jm)
        got = tadamw.opt_state_specs(tspecs, tmodel.param_shapes(ct), tm)
        assert norm(got.step) == norm(want.step) == ()
        assert flat(got.mu) == flat(want.mu)
        assert flat(got.nu) == flat(want.nu)
        assert (flat(tadamw.zero1_specs(tspecs, tmodel.param_shapes(ct), tm))
                == flat(jadamw.zero1_specs(jspecs, jmodel.param_shapes(cj), jm)))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_axes_match_jax(arch):
    cj, ct = configs(arch)
    want = jax.tree_util.tree_flatten_with_path(jmodel.param_shapes(cj))[0]
    got = {k: v for k, v in _paths(tmodel.param_shapes(ct))}
    assert len(got) == len(want)
    for path, sds in want:
        key = "/".join(p.key for p in path)
        t = got[key]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(sds.shape), key
        assert str(t.dtype).removeprefix("torch.") == str(sds.dtype), key
    jaxes = flat_axes(jmodel.param_axes(cj))
    assert flat_axes(tmodel.param_axes(ct)) == jaxes


def flat_axes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_axes(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = tuple(v)
    return out


def _paths(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, path)
        else:
            yield path, v


def _leaves(tree):
    if isinstance(tree, P):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


def test_spec_record_normalises_as_partition_spec():
    from jax.sharding import PartitionSpec as JP

    for entries in [(("data",), None), (("pod", "data"), "model"), (None, None), ()]:
        assert norm(P(*entries)) == norm(JP(*entries)), entries
    assert P(("data",), None) == P("data", None)


def test_placements_split_major_to_minor(meshes):
    from torch.distributed.tensor import Replicate, Shard

    _, tm = meshes["2x16x16"]
    assert tpart.placements(P(None, ("pod", "data"), "model"), tm) == (
        Shard(1), Shard(1), Shard(2))
    assert tpart.placements(P(None, None, ("pod", "data", "model")), tm) == (
        Shard(2), Shard(2), Shard(2))
    assert tpart.placements(P(), tm) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="major-to-minor"):
        tpart.placements(P(("model", "data")), tm)
    with pytest.raises(ValueError, match="twice"):
        tpart.placements(P("data", "data"), tm)
    with pytest.raises(ValueError, match="not an axis"):
        tpart.placements(P("expert"), tm)
    named = tpart.named({"a": P("model"), "b": {"c": P(None, "data")}}, tm)
    assert named == {"a": (Replicate(), Replicate(), Shard(0)),
                     "b": {"c": (Replicate(), Shard(1), Replicate())}}


@pytest.mark.parametrize("mesh_name", ["2x2", "2x16x16"])
def test_shard_slices_tile_the_tensor(meshes, mesh_name):
    """Every coordinate's slices under a spec that splits one dim over two
    axes tile the tensor exactly once, the first axis the most major."""
    _, tm = meshes[mesh_name]
    sizes = tpart.axis_sizes(tm)
    names = tuple(sizes)
    shape = (64, 32, 8)
    spec = P(names[:-1] if len(names) > 2 else names[0], names[-1], None)
    hits = np.zeros(shape, int)
    owner = np.full(shape, -1)
    for flat_idx, coord in enumerate(np.ndindex(*tm.shape)):
        sl = tpart.shard_slices(shape, spec, sizes, dict(zip(names, coord)))
        hits[sl] += 1
        owner[sl] = flat_idx
    assert (hits == 1).all()
    # dim 0's blocks run through the DP axes in row-major order
    n0 = int(np.prod([sizes[a] for a in tpart.spec_axes(spec[0])]))
    block = shape[0] // n0
    tp = sizes[names[-1]]
    assert [owner[i * block, 0, 0] // tp for i in range(n0)] == list(range(n0))


def test_mesh_builders_name_the_process_group_they_need(meshes):
    """Over the fake 512-rank group the multi-pod mesh builds; meshes of
    other sizes raise, naming the ranks they need."""
    m = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert m.mesh_dim_names == ("pod", "data", "model") and tuple(m.shape) == (2, 16, 16)
    with pytest.raises(RuntimeError, match="256 ranks; this one has 512"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="4 ranks; this one has 512"):
        tmesh.make_host_mesh(2, 2, device="cpu")


def test_ambient_mesh_is_scoped():
    assert ambient_mesh() is None
    with set_mesh("m") as m:
        assert m == "m" and ambient_mesh() == "m"
        with set_mesh(None):
            assert ambient_mesh() is None
        assert ambient_mesh() == "m"
    assert ambient_mesh() is None
