"""Training driver — the twin of :mod:`repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-demo-100m \
        --steps 50 --seq-len 256 --global-batch 32 [--no-falcon] \
        [--inject gpu:3:0.5:100:600] [--smoke] [--events] [--device cpu]

``--inject kind:target:severity:start:duration`` adds a fail-slow to the
attached cluster performance model (kind: gpu|cpu|link|nic). Detection and
mitigation run through :mod:`repro_torch.controlplane`; ``--events`` dumps
the control plane's typed event log after the run as JSON lines through
:func:`~repro_torch.controlplane.event_log_records` (Observations elided;
``--events-stride N`` samples every Nth per-job Observation into the dump).

``--smoke`` trains the reduced config; without it the published width
(``--arch mamba2-2.7b`` alone trains all 2.8 B parameters). The model runs
on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.cluster.injector import FailSlowInjector, Injection, InjectionKind
from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
from repro_torch.cluster.spec import ClusterSpec, ModelSpec
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.controlplane import event_log_records
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import FalconTrainer

KIND = {
    "gpu": InjectionKind.GPU_SLOW,
    "cpu": InjectionKind.CPU_CONTENTION,
    "link": InjectionKind.LINK_CONGESTION,
    "nic": InjectionKind.NIC_CONGESTION,
}


def parse_injection(text: str) -> Injection:
    """``kind:target:severity:start:duration``; a target of several ids is
    written ``a-b``."""
    kind, target, severity, start, duration = text.split(":")
    tgt = tuple(int(x) for x in target.split("-"))
    return Injection(
        start=float(start),
        duration=float(duration),
        kind=KIND[kind],
        target=tgt,
        severity=float(severity),
    )


def train_simulator(
    cfg: ArchConfig, data: DataConfig, *, sim_nodes: int = 2, device=None
) -> TrainingSimulator:
    """The performance model behind the iteration-time signal: ``sim_nodes``
    nodes of 4 GPUs, tp = 2, dp = the data's groups, pp = 1, sized from the
    trained model."""
    return TrainingSimulator(
        cluster=ClusterSpec(n_nodes=sim_nodes, gpus_per_node=4),
        job=JobSpec(
            model=ModelSpec(
                layers=cfg.num_layers,
                hidden=max(cfg.d_model, 1024),
                seq_len=data.seq_len,
                vocab=cfg.vocab_size,
            ),
            tp=2,
            dp=data.dp_groups,
            pp=1,
            micro_batches=data.slots * data.dp_groups,
        ),
        device=device,
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-demo-100m")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--dp-groups", type=int, default=4)
    ap.add_argument("--no-falcon", action="store_true")
    ap.add_argument("--inject", action="append", default=[])
    ap.add_argument("--sim-nodes", type=int, default=2)
    ap.add_argument(
        "--events", action="store_true",
        help="dump the control plane's typed event log after the run "
             "(JSON lines, the campaign-report serialization)",
    )
    ap.add_argument(
        "--events-stride", type=int, default=0,
        help="with --events, keep every Nth per-job Observation (0 = none)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    data = DataConfig(
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        slots=args.slots,
        dp_groups=args.dp_groups,
    )
    dev = resolve_device(args.device)
    sim = train_simulator(cfg, data, sim_nodes=args.sim_nodes, device=dev)
    injector = FailSlowInjector([parse_injection(t) for t in args.inject])

    trainer = FalconTrainer(
        cfg=cfg,
        data=data,
        opt_cfg=AdamWConfig(total_steps=args.steps),
        perf_model=sim,
        injector=injector,
        falcon_enabled=not args.no_falcon,
        device=dev,
    )
    history = trainer.run(args.steps)
    print("step,loss,iter_time,wall_time,strategy")
    for r in history:
        print(f"{r.step},{r.loss:.4f},{r.iter_time:.3f},{r.wall_time:.1f},{r.strategy or ''}")
    healthy = min(r.iter_time for r in history)
    mean = sum(r.iter_time for r in history) / len(history)
    print(f"# mean iter {mean:.3f}s vs healthy {healthy:.3f}s "
          f"(slowdown {mean / healthy:.2f}x)")
    if args.events and trainer.control is not None:
        print("# control-plane events:")
        for rec in event_log_records(
            trainer.control.events, observation_stride=args.events_stride
        ):
            print(json.dumps(rec, sort_keys=True))


if __name__ == "__main__":
    main()
