"""granite-4.0-h-small in the port: the dropless MoE over a held share of
the experts, a checkpoint a sub-layer, and the configuration fields whose
defaults leave every other configuration's numbers as they were."""
import dataclasses
import hashlib

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.optim import adamw


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and these many small operations slow down by tens of times when
    every worker spins a thread per core. The hashes below are of a
    one-thread run too."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(**kw):
    return dataclasses.replace(get_config("granite-4.0-h-small").smoke(), dtype="float32", **kw)


def _loss_and_grads(cfg, seed=3, seq=64, **kw):
    p = model_lib.init_params(cfg, seed, device="cpu")
    p = torch.utils._pytree.tree_map(lambda t: t.float().requires_grad_(True), p)
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=g)
    loss, _ = model_lib.loss_fn(p, {"tokens": toks, "labels": toks.roll(-1, 1)}, cfg, **kw)
    _, leaves = zip(*adamw.leaves(p))
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_the_smoke_model_keeps_the_published_period_and_a_consistent_share():
    full = get_config("granite-4.0-h-small")
    assert [s.mixer for s in full.period] == ["mamba"] * 5 + ["attn"] + ["mamba"] * 4
    assert {s.mlp for s in full.period} == {"moe"} and full.experts_held == 72
    cfg = dataclasses.replace(full, held_experts=9, expert_offset=63).smoke()
    assert (cfg.num_experts, cfg.held_experts, cfg.expert_offset) == (4, 4, 0)
    cfg = dataclasses.replace(full, held_experts=2, expert_offset=70).smoke()
    assert (cfg.held_experts, cfg.expert_offset) == (2, 2)
    shapes = model_lib.param_shapes(dataclasses.replace(full, held_experts=9))
    moe_leaves = shapes["blocks"]["sub5"]["moe"]
    assert tuple(moe_leaves["router"].shape) == (1 * 4, 4096, 72)
    assert tuple(moe_leaves["wi_gate"].shape) == (4, 9, 4096, 768)
    assert tuple(shapes["blocks"]["sub0"]["mamba"]["conv_x_bias"].shape) == (4, 8192)


def test_a_checkpoint_a_sublayer_gives_the_numbers_of_no_remat():
    cfg = _cfg(num_layers=10)  # one period: ten sub-layer checkpoints
    loss, grads = _loss_and_grads(cfg, remat=True)
    loss0, grads0 = _loss_and_grads(cfg, remat=False)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


#: float32 smoke loss and gradients of the parent commit (6ded8b7), one
#: intra-op thread: SHA-256 over the loss's and every gradient's bytes
BEFORE = {
    "granite-3-8b": "4c014ca1a516ca8127a12ee2f177bd25a9bb0d099ad7890b03d5736618bd6b1d",
    "mamba2-2.7b": "c7bd2375a6f6f0a3b2ca98fb1adfd85f0e1a5b4ee057f1e08f675e77123184c1",
    "olmoe-1b-7b": "645c08e2f4c9a4a44aa157f22a0a4cad90e9ba1cbaaa51e5c3e1036e02f51885",
    "jamba-1.5-large-398b": "f8da15015c0a1984f4641781ae531531ead70f25ecf679c8cd570896e0a6929b",
}


@pytest.mark.parametrize("arch", sorted(BEFORE))
def test_the_new_fields_at_their_defaults_leave_loss_and_gradients_as_before(arch):
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    loss, grads = _loss_and_grads(cfg)
    h = hashlib.sha256(loss.numpy().tobytes())
    for g in grads:
        h.update(g.numpy().tobytes())
    assert h.hexdigest() == BEFORE[arch]


def _layer(cfg, seed=0):
    params = model_lib.init_params(cfg, seed, device="cpu")["blocks"]["sub0"]["moe"]
    return {k: v[0].float() for k, v in params.items()}


def test_the_dropless_forward_waits_on_nothing_from_the_host():
    """On meta tensors every value is unknown to the host: a step that read
    one (``.item()``, a boolean mask, a data-dependent shape) would raise."""
    cfg = dataclasses.replace(_cfg(held_experts=2, expert_offset=1), dtype="bfloat16")
    meta = {"device": "meta", "dtype": torch.bfloat16}
    p = {k: torch.empty(v.shape, **meta) for k, v in _layer(cfg).items()}
    y, aux = moe.apply_moe(p, torch.empty((2, 32, cfg.d_model), **meta), cfg)
    assert y.shape == (2, 32, cfg.d_model) and y.device.type == "meta" and aux.shape == ()


def test_the_grouped_products_take_only_the_held_choices(monkeypatch):
    """The three products run on the held experts' routed rows alone, each
    expert's rows one segment; nothing of the other experts' choices."""
    cfg = _cfg(held_experts=2, expert_offset=1)
    p = _layer(cfg)
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    seen = []
    real = moe.grouped_mm

    def spy(a, w, offs):
        seen.append((a.shape[0], w.shape[0], offs.clone()))
        return real(a, w, offs)

    monkeypatch.setattr(moe, "grouped_mm", spy)
    moe.apply_moe(p, x, cfg)
    from repro_torch.models import layers

    hn = layers.rmsnorm(x, p["norm"], cfg.norm_eps).reshape(64, -1)
    _, idx, _ = moe.route(layers.matmul(hn, p["router"]), cfg.top_k, n_real=cfg.num_experts)
    want = torch.stack([(idx == e).sum() for e in (1, 2)]).cumsum(0).to(torch.int32)
    assert len(seen) == 3
    for rows, experts, offs in seen:
        assert rows == 64 * cfg.top_k and experts == 2
        assert torch.equal(offs, want) and int(offs[-1]) < rows


def test_dropless_keeps_every_choice_where_capacity_drops():
    """A router that sends every token to expert 0 first: the capacity
    dispatch drops most of them, the dropless one computes each."""
    cfg = _cfg()
    p = _layer(cfg)
    g = torch.Generator().manual_seed(2)
    common = torch.randn(cfg.d_model, generator=g)
    x = common + 0.1 * torch.randn((1, 64, cfg.d_model), generator=g)
    p["router"][:, 0] = 5.0 * common / common.norm()
    y, _ = moe.apply_moe(p, x, cfg)
    capped, _ = moe.apply_moe(p, x, dataclasses.replace(cfg, moe_dropless=False))
    from repro_torch.models import layers

    hn = layers.rmsnorm(x, p["norm"], cfg.norm_eps).reshape(64, -1)
    gates, idx, _ = moe.route(layers.matmul(hn, p["router"]), cfg.top_k, n_real=cfg.num_experts)
    assert int((idx[:, 0] == 0).sum()) == 64
    want = layers.apply_mlp({"norm": p["norm"], "wi_gate": p["shared_wi_gate"],
                             "wi_up": p["shared_wi_up"], "wo": p["shared_wo"]}, x, cfg)[0]
    for e in range(cfg.num_experts):
        w = (gates * (idx == e)).sum(-1)
        h = torch.nn.functional.silu(hn @ p["wi_gate"][e]) * (hn @ p["wi_up"][e])
        want = want + (h @ p["wo"][e]) * w[:, None]
    torch.testing.assert_close(y[0], want, rtol=1e-5, atol=1e-5)
    assert (capped[0] - want).abs().max() > 1e-2


@pytest.mark.parametrize("path", ["apply_moe", "sharded.moe"])
@pytest.mark.parametrize("share", [{}, {"moe_dropless": False, "held_experts": 2}],
                         ids=["dropless", "held_share"])
def test_the_mesh_paths_refuse_a_held_share_or_dropless_routing(path, share):
    """The mesh paths dispatch every expert by capacity: a configuration that
    holds a share or routes dropless is refused there, not quietly dropped,
    and the dry run's ``--all`` leaves it out."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import dryrun
    from repro_torch.models import sharded
    from repro_torch.models.schema import init_tree
    from repro_torch.sharding import set_mesh

    cfg = _cfg(**share)
    assert moe.mesh_refuses(cfg) and not moe.mesh_refuses(get_config("olmoe-1b-7b"))
    assert not any(a == "granite-4.0-h-small" for a, _, _ in
                   dryrun.combinations(None, None, True, "off"))
    params = init_tree(moe.moe_schema(cfg), 0, "cpu")
    x = torch.zeros((2, 3, cfg.d_model))
    dist.init_process_group("fake", store=FakeStore(), world_size=4, rank=0)
    try:
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        with torch.no_grad(), pytest.raises(ValueError, match="without a mesh"):
            if path == "apply_moe":
                with set_mesh(mesh):
                    moe.apply_moe(params, x, cfg)
            else:
                sharded.moe(params, {}, x, ("data",), cfg, mesh)
    finally:
        dist.destroy_process_group()
