"""The port's training slice (``repro_torch.{optim,data,train}``,
``repro_torch.launch.train``) against the JAX package.

* ``make_batch``: bit-identical batches for every modality.
* ``adamw``: the schedule, and 20 ``update`` steps with clipping engaged,
  from the same parameters, moments and gradients.
* ``FalconTrainer``: the port's trainer on the CPU against the reference's
  on the same starting parameters (the reference trainer's bfloat16 ones,
  carried over) and the same injection, on mamba2-2.7b and
  falcon-demo-100m at smoke size with a float32 config (activations in
  float32, weights bfloat16, as the reference runs it). Losses agree step
  by step; the control-plane event log (``event_log_records``) is
  identical over a run that flags, diagnoses and mitigates.
* Checkpoints cross packages: a JAX ``.npz`` restores into the port and
  the reverse, bfloat16 leaves included.

Tolerances: AdamW in float32 rtol 1e-5 (moments and float32 parameters:
the two frameworks round the same operations, summed in another order
inside the global norm); bfloat16 parameters within one bfloat16 step
(2^-7 relative), where an update lands on a rounding tie. Trainer losses:
rtol 1e-5. The two frameworks sum the same float32 products in another
order and round the updated bfloat16 weights (the losses part by at most
7.7e-7 relative over 40 steps on both archs); the margin covers an AdamW
step whose gradient is ~0, which moves a parameter by up to lr in either
direction (mhat / sqrt(vhat) is ±1 for any tiny gradient).
"""
import json
import warnings
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.injector import FailSlowInjector as JInjector
from repro.cluster.simulator import JobSpec as JJobSpec
from repro.cluster.simulator import TrainingSimulator as JSimulator
from repro.cluster.spec import ClusterSpec as JClusterSpec
from repro.cluster.spec import ModelSpec as JModelSpec
from repro.configs import base as jconfigs
from repro.controlplane import event_log_records as jrecords
from repro.core.events import Strategy as JStrategy
from repro.data import pipeline as jpipeline
from repro.launch import train as jlaunch
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch.cluster.injector import FailSlowInjector as TInjector
from repro_torch.configs import base as tconfigs
from repro_torch.controlplane import event_log_records as trecords
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.core.events import FailSlowEvent, RootCause
from repro_torch.core.events import Strategy as TStrategy
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import serve as tserve_launch
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer

F32_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
#: a GPU_SLOW on gpu:1 at 80 % of the way through the smoke job's 12th
#: iteration: FALCON diagnoses it at step 12 (verify window 8)
INJECT = "gpu:1:0.9:0.0008:200"
#: the planner's overheads scaled to the smoke job's ~7.7e-5 s iterations,
#: so that the ski-rental escalates S1 -> S2 -> S3 inside 40 steps
OVERHEAD_SCALE = 1e-4
STEPS = 40


def f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "falcon-demo-100m", "qwen2-vl-72b",
                                  "musicgen-large", "olmoe-1b-7b", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"])
def test_make_batch_is_bit_identical(arch):
    cfg_j = jconfigs.get_config(arch).smoke()
    cfg_t = tconfigs.get_config(arch).smoke()
    args = dict(seq_len=16, global_batch=8, slots=2, dp_groups=2, seed=7)
    for step in (0, 3):
        want = jpipeline.make_batch(cfg_j, jpipeline.DataConfig(**args), step)
        got = tpipeline.make_batch(cfg_t, tpipeline.DataConfig(**args), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_schedule_matches_jax():
    cfg_j = jadamw.AdamWConfig(warmup_steps=10, total_steps=50)
    cfg_t = tadamw.AdamWConfig(warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        want = float(jadamw.schedule(cfg_j, jnp.asarray(step, jnp.int32)))
        got = float(tadamw.schedule(cfg_t, torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, **F32_TOL)


def _param_tree(rng):
    return {
        "blocks": {"w": rng.normal(0, 0.02, (3, 8, 16)).astype(np.float32),
                   "norm": np.ones((3, 8), np.float32)},
        "embed": {"tok": rng.normal(0, 0.02, (32, 8)).astype(np.float32)},
        "scale": rng.normal(0, 1.0, (5,)).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_over_20_steps(dtype):
    rng = np.random.default_rng(3)
    cfg_j = jadamw.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=20, clip_norm=0.5)
    cfg_t = tadamw.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=20, clip_norm=0.5)
    params_j = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), _param_tree(rng))
    params_t = params_from_numpy(tree_np(params_j), "cpu")
    state_j = jadamw.init(params_j)
    state_t = tadamw.init(params_t)
    clipped = 0
    for _ in range(20):
        grads = jax.tree.map(lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32),
                             tree_np(params_j))
        grads_j = jax.tree.map(jnp.asarray, grads)
        clipped += float(jadamw.global_norm(grads_j)) > cfg_j.clip_norm
        params_j, state_j = jadamw.update(cfg_j, grads_j, state_j, params_j)
        params_t, state_t = tadamw.update(cfg_t, params_from_numpy(grads, "cpu"),
                                          state_t, params_t)
    assert clipped == 20   # the global-norm clip acted on every step
    assert int(state_t.step) == int(state_j.step) == 20
    assert state_t.step.dtype == torch.int32
    for (path, got), want in zip(tadamw.leaves(state_t.mu), jax.tree.leaves(state_j.mu)):
        assert got.dtype == torch.float32, path
        np.testing.assert_allclose(f32(got), f32(want), **F32_TOL)
    for got, want in zip([t for _, t in tadamw.leaves(state_t.nu)],
                         jax.tree.leaves(state_j.nu)):
        np.testing.assert_allclose(f32(got), f32(want), **F32_TOL)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    for (path, got), want in zip(tadamw.leaves(params_t), jax.tree.leaves(params_j)):
        assert got.dtype == getattr(torch, dtype), path
        np.testing.assert_allclose(f32(got), f32(want), **tol)


def test_opt_state_from_numpy_carries_a_jax_state():
    params = jax.tree.map(jnp.asarray, _param_tree(np.random.default_rng(4)))
    state = jadamw.init(params)
    grads = jax.tree.map(lambda a: a * 3.0, params)
    params, state = jadamw.update(jadamw.AdamWConfig(), grads, state, params)
    got = opt_state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    for (_, t), a in zip(tadamw.leaves(got.mu), jax.tree.leaves(state.mu)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    # The carried state continues as the reference's does.
    params_t = params_from_numpy(tree_np(params), "cpu")
    _, nxt_j = jadamw.update(jadamw.AdamWConfig(), grads, state, params)
    _, nxt_t = tadamw.update(tadamw.AdamWConfig(), params_from_numpy(tree_np(grads), "cpu"),
                             got, params_t)
    for (_, t), a in zip(tadamw.leaves(nxt_t.nu), jax.tree.leaves(nxt_j.nu)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), **F32_TOL)


def test_checkpoints_cross_packages(tmp_path):
    """A JAX ``save_disk`` restores through the port's ``restore_disk`` to
    identical tensors, bfloat16 leaves included, and the reverse; the
    in-memory round trip keeps values, types and devices."""
    rng = np.random.default_rng(5)
    tree = _param_tree(rng)
    params_j = {"blocks": jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree["blocks"]),
                "embed": jax.tree.map(jnp.asarray, tree["embed"]),
                "scale": jnp.asarray(tree["scale"], jnp.bfloat16)}
    state_j = jadamw.init(params_j)
    state_j = state_j._replace(step=jnp.asarray(7, jnp.int32))
    pack_j = {"params": params_j, "opt": state_j}

    like_t = {"params": params_from_numpy(tree_np(params_j), "cpu"),
              "opt": opt_state_from_numpy(tree_np(state_j), "cpu")}
    jm = jckpt.CheckpointManager(str(tmp_path / "jax"))
    jm.save_disk(pack_j, 3)
    tm = tckpt.CheckpointManager(str(tmp_path / "jax"))
    assert tm.latest_step() == 3
    zeros = jax.tree.map(torch.zeros_like, like_t)   # a like-tree of other values
    got = tm.restore_disk(zeros, 3)
    assert isinstance(got["opt"], tadamw.AdamWState)
    for (path, g), w in zip(_flat(got), jax.tree.leaves(pack_j)):
        assert g.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32,
                           "int32": torch.int32}[str(w.dtype)], path
        np.testing.assert_array_equal(f32(g), f32(w))
    assert sorted(np.load(jm.path(3)).files) == sorted(tckpt._flatten(like_t))

    # The reverse: the port writes, the reference reads.
    tm2 = tckpt.CheckpointManager(str(tmp_path / "torch"))
    tm2.save_disk(like_t, 4)
    back = jckpt.CheckpointManager(str(tmp_path / "torch")).restore_disk(
        jax.tree.map(jnp.zeros_like, pack_j), 4)
    for w, g in zip(jax.tree.leaves(pack_j), jax.tree.leaves(back)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(f32(g), f32(w))

    tm2.save_memory(like_t)
    mem = tm2.restore_memory()
    for (_, g), (_, w) in zip(_flat(mem), _flat(like_t)):
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g, w) and g.data_ptr() != w.data_ptr()


def _flat(tree):
    return list(tckpt._by_path(tree).items())


# ------------------------------------------------------------ the trainer
def jax_simulator(cfg, data):
    """The simulator ``repro.launch.train.main`` builds (--sim-nodes 2)."""
    return JSimulator(
        cluster=JClusterSpec(n_nodes=2, gpus_per_node=4),
        job=JJobSpec(
            model=JModelSpec(layers=cfg.num_layers, hidden=max(cfg.d_model, 1024),
                             seq_len=data.seq_len, vocab=cfg.vocab_size),
            tp=2, dp=data.dp_groups, pp=1, micro_batches=data.slots * data.dp_groups,
        ),
    )


def trainers(arch, tmp_path, steps):
    """The reference's trainer and the port's on the CPU with a float32
    config, from the reference trainer's parameters (bfloat16, as its
    ``init_params`` makes them, carried over bit for bit), with the same
    injection."""
    cfg_j = replace(jconfigs.get_config(arch).smoke(), dtype="float32")
    cfg_t = replace(tconfigs.get_config(arch).smoke(), dtype="float32")
    args = dict(seq_len=32, global_batch=8, slots=2, dp_groups=2)
    data_j, data_t = jpipeline.DataConfig(**args), tpipeline.DataConfig(**args)
    over_j = {s: v * OVERHEAD_SCALE for s, v in jtrainer.DEFAULT_OVERHEADS.items()}
    over_t = {TStrategy[s.name]: v for s, v in over_j.items()}
    tr_j = jtrainer.FalconTrainer(
        cfg=cfg_j, data=data_j, opt_cfg=jadamw.AdamWConfig(total_steps=steps),
        perf_model=jax_simulator(cfg_j, data_j),
        injector=JInjector([jlaunch.parse_injection(INJECT)]),
        overheads=over_j, ckpt_dir=str(tmp_path / "jax"),
    )
    tr_t = ttrainer.FalconTrainer(
        cfg=cfg_t, data=data_t, opt_cfg=tadamw.AdamWConfig(total_steps=steps),
        perf_model=tlaunch.train_simulator(cfg_t, data_t, device="cpu"),
        injector=TInjector([tlaunch.parse_injection(INJECT)]),
        overheads=over_t, ckpt_dir=str(tmp_path / "torch"), device="cpu",
    )
    tr_t.params = params_from_numpy(tree_np(tr_j.params), "cpu")
    tr_t.opt_state = tadamw.init(tr_t.params)
    return tr_j, tr_t


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "falcon-demo-100m"])
def test_trainer_matches_jax_trainer(arch, tmp_path):
    tr_j, tr_t = trainers(arch, tmp_path, STEPS)
    hist_j = tr_j.run(STEPS)
    hist_t = tr_t.run(STEPS)
    losses_j = np.array([r.loss for r in hist_j])
    losses_t = np.array([r.loss for r in hist_t])
    assert np.isfinite(losses_t).all()
    np.testing.assert_allclose(losses_t, losses_j, **LOSS_TOL)
    for a, b in zip(hist_t, hist_j):
        assert (a.step, a.iter_time, a.wall_time, a.strategy) == \
            (b.step, b.iter_time, b.wall_time, b.strategy)
    assert tr_t.allocation == tr_j.allocation
    recs_j = jrecords(tr_j.control.events)
    recs_t = trecords(tr_t.control.events)
    assert json.dumps(recs_t, sort_keys=True) == json.dumps(recs_j, sort_keys=True)
    kinds = [r["type"] for r in recs_t]
    assert "Diagnosis" in kinds and "MitigationResult" in kinds
    applied = [r.strategy for r in hist_t if r.strategy]
    assert applied[:3] == ["IGNORE", "ADJUST_MICROBATCH", "ADJUST_TOPOLOGY"], applied
    # The parameters trained alike: bfloat16 leaves, each within two
    # bfloat16 steps (each update, ~lr = 1e-4 against weights ~0.01, moves
    # a weight by about one step, and either package may round it the
    # other way: a few in 10^5 weights part by two steps after 40 updates),
    # or within a tenth of the last step's learning rate (1.2e-4) where a
    # leaf that starts at zero (a_log, dt_bias) took a near-zero gradient,
    # whose sign decides the AdamW step (measured: 1.4e-6).
    for (path, got), want in zip(tadamw.leaves(tr_t.params), jax.tree.leaves(tr_j.params)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, path
        np.testing.assert_allclose(f32(got), f32(want), rtol=2 ** -6, atol=1e-5, err_msg=path)


def test_moe_trainer_matches_jax_trainer(tmp_path):
    """olmoe-1b-7b (attention + 4 experts top 2 at smoke size, the aux loss
    in the objective): the losses step by step, the event log and the
    strategies as for the dense archs. The trained parameters are held by
    the count of weights farther apart than two bfloat16 steps as above: at
    most 1e-5 of all weights (measured here: one among 1.6 million, parted
    by 1.8e-4, a near-zero gradient whose sign decided several steps). That
    count is the check. The per-leaf bound beside it, the learning rates
    summed over the run (plus their decay terms), only rules out a leaf
    that did not train: AdamW steps of opposite sign can part two weights
    by that much, so it holds for any two sound runs."""
    arch = "olmoe-1b-7b"
    tr_j, tr_t = trainers(arch, tmp_path, STEPS)
    hist_j = tr_j.run(STEPS)
    hist_t = tr_t.run(STEPS)
    losses_j = np.array([r.loss for r in hist_j])
    losses_t = np.array([r.loss for r in hist_t])
    assert np.isfinite(losses_t).all()
    np.testing.assert_allclose(losses_t, losses_j, **LOSS_TOL)
    for a, b in zip(hist_t, hist_j):
        assert (a.step, a.iter_time, a.wall_time, a.strategy) == \
            (b.step, b.iter_time, b.wall_time, b.strategy)
    assert tr_t.allocation == tr_j.allocation
    assert json.dumps(trecords(tr_t.control.events), sort_keys=True) == \
        json.dumps(jrecords(tr_j.control.events), sort_keys=True)
    applied = [r.strategy for r in hist_t if r.strategy]
    assert applied[:3] == ["IGNORE", "ADJUST_MICROBATCH", "ADJUST_TOPOLOGY"], applied
    lr_sum = sum(float(tadamw.schedule(tr_t.opt_cfg, torch.tensor(s, dtype=torch.int32)))
                 for s in range(STEPS)) * (1 + 2 * tr_t.opt_cfg.weight_decay)
    far, total = 0, 0
    for (path, got), want in zip(tadamw.leaves(tr_t.params), jax.tree.leaves(tr_j.params)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, path
        g, w = f32(got), f32(want)
        assert np.abs(g - w).max() <= lr_sum, (path, np.abs(g - w).max(), lr_sum)
        far += int((np.abs(g - w) > 2 ** -6 * np.abs(w) + 1e-5).sum())
        total += g.size
    assert far <= 1e-5 * total, (far, total)


def test_ckpt_restart_shim_restores_the_same_parameters(tmp_path):
    """S4 through the deprecated ``_apply_strategy`` shim: the in-memory
    checkpoint restore gives back the same parameters, and the allocation
    returns to an even split, as in the reference."""
    _, tr = trainers("mamba2-2.7b", tmp_path, 2)
    tr.run(1)
    before = {p: t.clone() for p, t in tadamw.leaves(tr.params)}
    tr.allocation = [1, 3]
    event = FailSlowEvent(start_time=0.0, root_cause=RootCause.GPU_DEGRADATION,
                          components=["gpu:1"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr._apply_strategy(TStrategy.CKPT_AND_RESTART, event)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert tr.allocation == [tr.data.slots] * tr.data.dp_groups
    for path, t in tadamw.leaves(tr.params):
        assert torch.equal(t, before[path]), path
    tr.run(1)   # training continues from the restored parameters


def test_train_step_takes_float32_gradient_sums():
    """The step sums per-slot bf16 gradients in float32, in slot order."""
    cfg = tconfigs.get_config("falcon-demo-100m").smoke()
    data = tpipeline.DataConfig(seq_len=16, global_batch=4, slots=2, dp_groups=1)
    params = tmodel.init_params(cfg, 0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in tpipeline.make_batch(cfg, data, 0).items()}
    grads = []
    for i in range(2):
        mb = tts._take_slot(batch, i, cfg)
        flat = [t.requires_grad_(True) for _, t in tadamw.leaves(params)]
        loss, _ = tmodel.loss_fn(params, mb, cfg)
        grads.append(torch.autograd.grad(loss, flat))
    want = [(a.float() + b.float()) / 2 for a, b in zip(*grads)]
    seen = {}
    real_update = tadamw.update

    def spy(cfg_, g, state, p):
        seen.update(tadamw.leaves(g))
        return real_update(cfg_, g, state, p)

    tts.adamw.update = spy
    try:
        step = tts.make_train_step(cfg, tadamw.AdamWConfig())
        _, state, metrics = step(params, tadamw.init(params), batch)
    finally:
        tts.adamw.update = real_update
    assert int(state.step) == 1 and bool(torch.isfinite(metrics["loss"]))
    for (path, got), w in zip(seen.items(), want):
        assert got.dtype == torch.float32, path
        torch.testing.assert_close(got, w, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["falcon-demo-100m", "qwen2-vl-72b"])
def test_train_step_raises_on_a_leaf_the_loss_does_not_reach(arch):
    """Only a vision model's token table may take no part in the loss (its
    inputs are embeds); any other such leaf is a wiring fault and raises."""
    cfg = tconfigs.get_config(arch).smoke()
    data = tpipeline.DataConfig(seq_len=16, global_batch=2, slots=1, dp_groups=1)
    params = tmodel.init_params(cfg, 0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in tpipeline.make_batch(cfg, data, 0).items()}
    step = tts.make_train_step(cfg, tadamw.AdamWConfig())
    params["stray"] = {"w": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="not have been used"):
        step(params, tadamw.init(params), batch)


def test_train_step_kernel_route_raises():
    """The SSD kernel has no gradient, so a mamba train step with
    ``use_kernel`` raises, as the reference's does under ``jax.grad``."""
    cfg = tconfigs.get_config("mamba2-2.7b").smoke()
    data = tpipeline.DataConfig(seq_len=16, global_batch=2, slots=1, dp_groups=1)
    params = tmodel.init_params(cfg, 0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in tpipeline.make_batch(cfg, data, 0).items()}
    step = tts.make_train_step(cfg, tadamw.AdamWConfig(), use_kernel=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        step(params, tadamw.init(params), batch)


def test_train_cli_runs_on_the_cpu(capsys):
    tlaunch.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu", "--steps", "3",
                  "--seq-len", "16", "--global-batch", "4", "--slots", "2",
                  "--dp-groups", "2", "--events"])
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln[:1].isdigit()]
    assert len(rows) == 3 and "# mean iter" in out and "# control-plane events:" in out
    assert all(np.isfinite(float(r.split(",")[1])) for r in rows)
    ap = tlaunch.build_parser()
    assert ap.parse_args([]).smoke is False    # the published width by default
    assert ap.parse_args(["--smoke"]).smoke is True


def test_serve_uses_the_train_driver_parse_injection():
    assert tserve_launch.parse_injection is tlaunch.parse_injection
    inj = tlaunch.parse_injection("link:0-1:0.3:5:20")
    ref = jlaunch.parse_injection("link:0-1:0.3:5:20")
    assert (inj.start, inj.duration, inj.kind.name, inj.target, inj.severity) == \
        (ref.start, ref.duration, ref.kind.name, ref.target, ref.severity)


def test_trainer_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    cfg = tconfigs.get_config("falcon-demo-100m").smoke()
    data = tpipeline.DataConfig(seq_len=16, global_batch=2, slots=1, dp_groups=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.FalconTrainer(cfg=cfg, data=data)


def test_jax_strategy_names_match():
    assert [s.name for s in JStrategy] == [s.name for s in TStrategy]
