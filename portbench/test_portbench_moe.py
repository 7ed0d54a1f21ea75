"""The cells whose configurations hold a share of a mixture of experts
(``train_moe`` mixes), at a size the CPU holds: the port agrees with the
plain reference (``portbench/reference/arch/granitemoehybrid.py``) in loss,
logits and first gradients; the shares of a layer add up to the uncut
layer; a skewed router loses nothing; in the comparison that decides
``correct`` the port reads far below the control, and the control and a
broken step fail; the yardstick's count; and the readers of the cells' own
per-layer metrics."""
import copy
import dataclasses
import time

import pytest
import torch

from portbench import bench
from portbench.drivers import train
from portbench.reference import lm, weights
from portbench.reference import train as ref_train
from portbench.test_portbench_train import _half_batch, _unchanged

WORKLOADS = bench.benchmark()["workloads"]
CELLS = [w["name"] for w in WORKLOADS if bench.cell(w["name"]).traffic["driver"] == "train_moe"]
SEED = 2**31 + 271


def small(name: str, held: int = 2, offset: int = 2) -> bench.Cell:
    """Cell ``name`` cut in width, experts and length: one whole period,
    8 published experts of which ``held`` are held from ``offset``."""
    c = bench.cell(name)
    conf = copy.deepcopy(c.config)
    conf.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=8,
                mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=16, num_experts_per_tok=3,
                num_local_experts=held, expert_offset=offset, intermediate_size=32,
                shared_intermediate_size=48, vocab_size=500)
    conf["published"] = dict(conf["published"], num_local_experts=8)
    c.config = conf
    c.traffic = dict(c.traffic, seq_len=64)
    return c


def _port(c, flat):
    """The port's ``ArchConfig`` in float32 and its parameter tree of
    ``flat``'s weights in float32, requiring grad."""
    from portbench.drivers.common import port_config

    arch = dataclasses.replace(port_config(c.config, weights.sizes(c.config)), dtype="float32")
    return arch, weights.nest({k: v.float().requires_grad_(True) for k, v in flat.items()})


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference_in_loss_logits_and_gradients(name):
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw

    c = small(name)
    sz = weights.sizes(c.config)
    assert sz["period"].count("attn") == 1 and len(sz["period"]) == 10
    flat = weights.make(sz, SEED, "cpu")
    g = torch.Generator().manual_seed(SEED)
    toks = torch.randint(0, sz["vocab"], (2, 48), generator=g)
    labels = torch.randint(0, sz["vocab"], (2, 48), generator=g)
    w = {k: v.float().requires_grad_(True) for k, v in flat.items()}
    want = lm.loss(w, toks, labels, sz, lm.Precision("f32"))
    want_grads = dict(zip(sorted(w), torch.autograd.grad(want, [w[k] for k in sorted(w)])))
    arch, p = _port(c, flat)
    got, _ = model_lib.loss_fn(p, {"tokens": toks, "labels": labels}, arch)
    paths, leaves = zip(*adamw.leaves(p))
    got_grads = dict(zip(paths, torch.autograd.grad(got, leaves)))
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-6)
    for k, gw in want_grads.items():
        torch.testing.assert_close(got_grads[k], gw, rtol=1e-4, atol=1e-4 * float(gw.abs().max()))
    with torch.no_grad():
        logits = model_lib.forward(p, {"tokens": toks}, arch)[0][..., : sz["vocab"]]
    torch.testing.assert_close(logits, lm.logits(flat, toks, sz, lm.Precision("f32")),
                               rtol=1e-4, atol=1e-4)


def _moe_layer(c, flat, j=0):
    sz = weights.sizes(c.config)
    return sz, {k[len(f"blocks/sub{j}/"):]: v[0].float() for k, v in flat.items()
                if k.startswith(f"blocks/sub{j}/moe/")}


@pytest.mark.parametrize("name", CELLS)
def test_four_shares_of_a_layer_add_up_to_the_uncut_layer(name):
    """8 experts over 4 chips, 2 each: the port's four partial outputs,
    with the shared expert (which every chip computes) counted once, are
    the uncut reference layer's."""
    from repro_torch.models import layers, moe

    whole = small(name, held=8, offset=0)
    sz, p = _moe_layer(whole, weights.make(weights.sizes(whole.config), SEED, "cpu"))
    x = torch.randn((2, 32, sz["d"]), generator=torch.Generator().manual_seed(3))
    ref = weights.sizes(whole.config)["arch"]
    want = ref._moe(x, p, sz, lm.Precision("f32"))
    parts = []
    for r in range(4):
        c = small(name, held=2, offset=2 * r)
        arch, _ = _port(c, {})
        share = {k[len("moe/"):]: v for k, v in p.items()}
        for k in ("wi_gate", "wi_up", "wo"):
            share[k] = share[k][2 * r:2 * r + 2]
        parts.append(moe.apply_moe(share, x, arch)[0])
    hn = layers.rmsnorm(x, p["moe/norm"], sz["eps"]).reshape(-1, sz["d"])
    shared = moe._shared({k[len("moe/"):]: v for k, v in p.items()}, hn).reshape(x.shape)
    torch.testing.assert_close(sum(parts) - 3 * shared, want, rtol=1e-5, atol=1e-5)
    assert all((part - shared).abs().max() > 1e-4 for part in parts)


@pytest.mark.parametrize("name", CELLS)
def test_a_skewed_router_drops_nothing(name):
    """A router that sends every token to held expert 0 first: the port's
    layer is the reference's, every choice computed."""
    from repro_torch.models import moe
    from repro_torch.obs import runtime

    c = small(name, held=2, offset=0)
    sz, p = _moe_layer(c, weights.make(weights.sizes(c.config), SEED, "cpu"))
    g = torch.Generator().manual_seed(5)
    common = torch.randn(sz["d"], generator=g)
    x = common + 0.1 * torch.randn((1, 64, sz["d"]), generator=g)
    p["moe/router"][:, 0] = 5.0 * common / common.norm()
    want = sz["arch"]._moe(x, p, sz, lm.Precision("f32"))
    arch, _ = _port(c, {})
    runtime.reset()
    with runtime.recording():
        got, _ = moe.apply_moe({k[len("moe/"):]: v for k, v in p.items()}, x, arch)
    counted = runtime.counts()["moe.held_routed"]
    runtime.reset()
    assert counted["max"] == 64          # every token's first choice, none dropped
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CELLS)
def test_the_port_reads_far_below_the_control_which_fails_a_limit(name):
    """The driver's comparison at the small cut, bf16 port against the
    float32 reference: each gap of the port is under half the fp8
    control's, and the control fails a limit of the cell. (The cell's
    limits are set from the published widths on the card, where each
    leaf's norm averages over far more elements and routed tokens: the
    port's gaps here run several times the card's, so the comparison here
    is with the control on the same seed.)"""
    c = small(name)
    r = train.Run(c, SEED + 17, "cpu")
    first = r.first
    r.free()
    want = r.reference()
    port = ref_train.compare(first, want)
    control = ref_train.compare(r.reference(precision="fp8"), want)
    assert all(port[k] < control[k] / 2 for k in port), (port, control)
    assert any(control[k] > lim for k, lim in c.limits.items() if k in control), (control, c.limits)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_step_is_not_correct(name, fault):
    out = train.run(small(name), SEED + 29, 0.2, False, "cpu", time.perf_counter(), plant=fault)
    assert out["correct"] is False, out["checks"]


def test_train_flops_equal_worked_values():
    """One period of 9 Mamba2 sub-layers (z, x, out 4096 x 8192; B/C 4096
    x 256; dt 4096 x 128) and one attention sub-layer (q, o 4096^2; k, v
    4096 x 1024), each with a router over 72 experts, a shared expert of
    1,536 and 10 x 9 / 72 = 1.25 held experts of 768 a token, and a 4096 x
    100352 head; 2 x 8,192 tokens; the SSD's 128 heads x 32 chunks of 256
    in 9 sub-layers and the causal attention 2 * S^2 * 32 * 128, times 3."""
    from portbench import yardstick

    sz = weights.sizes(bench.cell(CELLS[0]).config)
    mamba = 3 * 4096 * 8192 + 4096 * 256 + 4096 * 128
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    moe_layer = 4096 * 72 + 3 * 4096 * 1536 + 1.25 * 3 * 4096 * 768
    dense = 6 * (9 * mamba + attn + 10 * moe_layer + 4096 * 100352) * 16384
    ssd = 9 * 128 * 32 * (2 * 32896 * 128 + 2 * 32896 * 64 + 4 * 256 * 128 * 64)
    mixing = 3 * 2 * (ssd + 2 * 8192**2 * 32 * 128)
    assert yardstick.train_step_flops(sz, 8192, 2) == pytest.approx(dense + mixing, rel=1e-12)
    assert yardstick.train_step_flops(sz, 8192, 2) == pytest.approx(1.7337e14, rel=1e-4)


def _t(count, device_s):
    return {"count": count, "host_s": 1.0, "self_s": 1.0, "device_s": device_s}


MOE = {"train.compute": _t(2, 8.0), "moe.route": _t(80, 0.2), "moe.experts": _t(80, 0.5),
       "moe.combine": _t(80, 0.1)}


def test_moe_pct_reads_a_fabricated_record(monkeypatch):
    from repro_torch.obs import runtime

    monkeypatch.setattr(runtime, "totals", lambda: MOE)
    read = bench.reader("moe_pct.hybrid_train")
    assert read({"driver": "train"}) == pytest.approx(10.0, rel=1e-12)
    assert read({"driver": "serve"}) is None
    monkeypatch.setattr(runtime, "totals", lambda: {k: dict(v, device_s=None)
                                                    for k, v in MOE.items()})
    assert read({"driver": "train"}) is None


def test_expert_gemm_roofline_reads_a_fabricated_trace(monkeypatch):
    """10,000 held choices in the forwards at d 4,096 and width 768: 4
    passes of 2 * 3 * d * 768 FLOPs each, 7.55e13 FLOPs, over 0.1 s of
    grouped-GEMM kernels is 76.3 % of 989 TFLOP/s."""
    from repro_torch.obs import runtime

    monkeypatch.setattr(runtime, "counts", lambda within=None: {
        "moe.held_routed": {"ticks": 20, "sum": 10_000, "max": 700}})
    trace = {"by_op": {"cutlass::device_kernel<GroupProblemShape<...>>": 0.09,
                       "prepare_grouped_gemm_data<...>": 0.01, "nvjet_tst_192x192": 3.0}}
    read = bench.reader("expert_gemm_roofline.hybrid_train")
    want = 100.0 * 4 * 10_000 * 2 * 3 * 4096 * 768 / 0.1 / 989e12
    assert read({"driver": "train", "trace": trace}) == pytest.approx(want, rel=1e-12)
    assert read({"driver": "train", "trace": {"by_op": {"nvjet": 1.0}}}) is None
    assert read({"driver": "serve", "trace": trace}) is None


@pytest.mark.parametrize("name", CELLS)
def test_the_readers_find_nothing_on_a_cpu_run_and_the_counter_counts(name):
    """A traced run of the cut cell on the CPU: its spans have no device
    seconds and its trace no kernels, so neither reader gives a number,
    and the counter holds the forwards' held choices of the traced steps."""
    from repro_torch.obs import runtime

    c = small(name)
    runtime.reset()
    out = train.run(c, SEED + 31, 0.2, True, "cpu", time.perf_counter())
    assert "moe_pct.hybrid_train" not in out["metrics"]
    assert "expert_gemm_roofline.hybrid_train" not in out["metrics"]
    t = runtime.totals()
    layers = len(weights.sizes(c.config)["period"])
    steps, slots = c.traffic["trace_steps"], c.traffic["slots"]
    assert t["moe.route"]["count"] == 2 * steps * slots * layers      # forward and recompute
    counted = runtime.counts(within="train.forward")["moe.held_routed"]
    assert counted["ticks"] == steps * slots * layers and 0 < counted["sum"]
    runtime.reset()
