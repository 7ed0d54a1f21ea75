"""End-to-end run: train the ~100M falcon-demo model for a few hundred
steps with FALCON protecting the run — the PyTorch port's twin of
``examples/train_100m_falcon.py``.

The model trains for real (8 layers, d=768, 32k vocab ~= 100M params; loss
decreases on the structured synthetic stream). The attached cluster
performance model, a (2TP, 4DP, 2PP) job on 2 x 8 GPUs, replays a mixed
fail-slow trace — computation and communication episodes like the paper's
Fig. 20 — and FALCON detects and mitigates each one. On the card the model
trains there and the simulator's reduction runs the ``cell_reduce`` kernel;
the per-job detector is the host's scalar BOCD, as in the reference. The
run prints a
per-phase summary plus the strategy timeline, and checkpoints at the end
under ``build/`` (``--ckpt-dir``).

``--smoke`` trains the reduced falcon-demo config instead (the CPU tests'
size); the simulator, the injections and so the timeline are the same.

Run:  PYTHONPATH=src python examples/torch_train_100m_falcon.py [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.cluster.injector import FailSlowInjector, Injection, InjectionKind
from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
from repro_torch.cluster.spec import ClusterSpec, ModelSpec
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import FalconTrainer

CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "build", "repro_torch_examples", "ckpt")


def make_simulator(device) -> TrainingSimulator:
    """Performance model: 2 nodes x 8 GPUs, (2TP, 4DP, 2PP)."""
    return TrainingSimulator(
        cluster=ClusterSpec(n_nodes=2, gpus_per_node=8),
        job=JobSpec(
            model=ModelSpec(layers=24, hidden=2048, seq_len=1024, vocab=32000),
            tp=2, dp=4, pp=2, micro_batches=16,
        ),
        device=device,
    )


def make_injector(t0: float) -> FailSlowInjector:
    return FailSlowInjector([
        # GPU 5 thermal-throttles early in the run.
        Injection(start=20 * t0, duration=60 * t0,
                  kind=InjectionKind.GPU_SLOW, target=(5,), severity=0.45),
        # Node 1's NIC congests mid-run (communication fail-slow).
        Injection(start=100 * t0, duration=70 * t0,
                  kind=InjectionKind.NIC_CONGESTION, target=(1,), severity=0.7),
    ])


def main(argv=None) -> FalconTrainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--no-falcon", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced falcon-demo config (CPU tests)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("falcon-demo-100m")
    if args.smoke:
        cfg = cfg.smoke()
    n_params = cfg.total_params()
    print(f"model: {cfg.name} ({n_params/1e6:.0f}M params)")

    data = DataConfig(
        seq_len=args.seq_len, global_batch=8, slots=2, dp_groups=4
    )
    sim = make_simulator(device)
    t0 = sim.healthy_iteration_time()
    injector = make_injector(t0)

    trainer = FalconTrainer(
        cfg=cfg,
        data=data,
        opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=20),
        perf_model=sim,
        injector=injector,
        falcon_enabled=not args.no_falcon,
        ckpt_dir=args.ckpt_dir,
        device=device,
    )
    history = trainer.run(args.steps)

    losses = np.array([h.loss for h in history])
    times = np.array([h.iter_time for h in history])
    print(f"\nloss: first10={losses[:10].mean():.3f} "
          f"last10={losses[-10:].mean():.3f}")
    print(f"iteration time: healthy={t0:.2f}s "
          f"mean={times.mean():.2f}s p95={np.percentile(times, 95):.2f}s")
    print(f"total wall (modeled): {history[-1].wall_time/60:.1f} min")
    print("\nstrategy timeline:")
    for h in history:
        if h.strategy:
            print(f"  step {h.step:>4}: {h.strategy}")
    for ev in trainer.detector.history if trainer.detector else []:
        print(f"detected: {ev.root_cause.value} {ev.components} "
              f"({ev.t_healthy:.2f}s -> {ev.t_slow:.2f}s)")

    trainer.ckpt.save_disk(trainer.params, step=args.steps)
    print(f"\ncheckpoint saved to {trainer.ckpt.path(args.steps)}")
    assert losses[-10:].mean() < losses[:10].mean(), "loss should decrease"
    print("train_100m_falcon OK")
    return trainer


if __name__ == "__main__":
    main()
