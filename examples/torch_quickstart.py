"""Quickstart: FALCON in ~60 lines — the PyTorch port's twin of
``examples/quickstart.py``.

1. Train a tiny model for a handful of real PyTorch steps.
2. Attach the cluster performance model and inject a GPU fail-slow.
3. Watch FALCON-DETECT pinpoint it and FALCON-MITIGATE escalate S1 -> S2.

The model, the simulator and the control plane's screen run on ``--device``
(default: the card; ``cpu`` on request).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.cluster.injector import FailSlowInjector, Injection, InjectionKind
from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
from repro_torch.cluster.spec import ClusterSpec, ModelSpec
from repro_torch.configs.base import get_config
from repro_torch.core.events import Strategy
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.train.trainer import FalconTrainer


def main(argv=None) -> FalconTrainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)

    # A reduced falcon-demo model (real parameters, real optimizer updates).
    cfg = get_config("falcon-demo-100m").smoke()
    data = DataConfig(seq_len=64, global_batch=16, slots=4, dp_groups=4)

    # The performance model: one 8-GPU node running (1TP, 4DP, 2PP).
    sim = TrainingSimulator(
        cluster=ClusterSpec(n_nodes=1, gpus_per_node=8),
        job=JobSpec(
            model=ModelSpec(layers=12, hidden=1024, seq_len=512, vocab=32000),
            tp=1, dp=4, pp=2, micro_batches=16,
        ),
        device=device,
    )
    # GPU 2 loses 50 % of its speed from iteration ~20 to ~60.
    t0 = sim.healthy_iteration_time()
    injector = FailSlowInjector([
        Injection(start=20 * t0, duration=40 * t0,
                  kind=InjectionKind.GPU_SLOW, target=(2,), severity=0.5)
    ])

    # Strategy overheads expressed in simulated-iteration units so the
    # ski-rental escalation is visible within this short run.
    overheads = {
        Strategy.IGNORE: 0.0,
        Strategy.ADJUST_MICROBATCH: 5 * t0,
        Strategy.ADJUST_TOPOLOGY: 60 * t0,
        Strategy.CKPT_AND_RESTART: 1000 * t0,
    }
    trainer = FalconTrainer(
        cfg=cfg, data=data, perf_model=sim, injector=injector,
        falcon_enabled=True, overheads=overheads, device=device,
    )
    history = trainer.run(80)

    print(f"{'step':>4} {'loss':>8} {'iter_s':>8}  strategy")
    for rec in history:
        if rec.step % 10 == 0 or rec.strategy:
            print(f"{rec.step:>4} {rec.loss:>8.3f} {rec.iter_time:>8.3f}  "
                  f"{rec.strategy or ''}")
    events = trainer.detector.history + (
        [trainer.detector.active_event] if trainer.detector.active_event else []
    )
    for ev in events:
        print(
            f"\nFALCON-DETECT: {ev.root_cause.value} on {ev.components}, "
            f"iteration {ev.t_healthy:.2f}s -> {ev.t_slow:.2f}s "
            f"(severity {ev.severity:.0%})"
        )
    assert history[-1].loss < history[0].loss, "loss should decrease"
    print("\nquickstart OK")
    return trainer


if __name__ == "__main__":
    main()
