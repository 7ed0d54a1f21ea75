"""Training loop with FALCON integrated as a first-class runtime feature —
the twin of :mod:`repro.train.trainer`.

The trainer executes *real* PyTorch training steps (params genuinely
update) and feeds FALCON an iteration-time signal. On real hardware that
signal is the measured step time; when a :class:`TrainingSimulator` +
:class:`FailSlowInjector` are attached (the same cluster performance model
as the paper-reproduction benchmarks), fail-slows are modeled by it, so
detection and mitigation operate on honest dynamics while the numerics
stay real.

Detection and mitigation run through the control plane
(:mod:`repro_torch.controlplane`): the trainer registers its performance
model as a job and drives :meth:`ControlPlane.observe` once per step;
strategy dispatch goes through the job's
:class:`~repro_torch.controlplane.strategies.StrategyRegistry` (S1 ignore /
S2 micro-batch / S3 topology / S4 ckpt-restart). The trainer's only
mitigation role is mirroring results into its own state: S2 allocations
into ``allocation``, S4 into an in-memory checkpoint restore.
``FalconTrainer._apply_strategy`` remains as a thin deprecation shim over
the registry.

The trainer runs on ``device`` (None = the card, raising when there is
none; ``"cpu"`` on request). :func:`remap_mesh` is the runtime analogue
of S3 on a DeviceMesh (a rank permutation of the mesh); the adaptive S2
step is :func:`repro_torch.train.train_step.make_adaptive_train_step`.
"""
from __future__ import annotations

import os
import tempfile
import time
import warnings
from dataclasses import dataclass, field

import torch

from repro_torch.cluster.injector import FailSlowInjector
from repro_torch.cluster.simulator import TrainingSimulator
from repro_torch.configs.base import ArchConfig
from repro_torch.controlplane import ControlPlane, MitigationResult
from repro_torch.controlplane.strategies import MitigationContext
from repro_torch.core.detector import FalconDetect
from repro_torch.core.events import Strategy, strategy_label
from repro_torch.core.monitor import Monitor
from repro_torch.core.planner import DEFAULT_OVERHEADS
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts_lib
from repro_torch.train.checkpoint import CheckpointManager


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class StepRecord:
    step: int
    loss: float
    iter_time: float
    wall_time: float
    strategy: str | None = None


@dataclass
class FalconTrainer:
    cfg: ArchConfig
    data: DataConfig
    opt_cfg: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    #: cluster performance model supplying iteration times (+ fail-slows)
    perf_model: TrainingSimulator | None = None
    injector: FailSlowInjector | None = None
    falcon_enabled: bool = True
    overheads: dict = field(default_factory=lambda: dict(DEFAULT_OVERHEADS))
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    seed: int = 0
    #: torch device of the parameters and steps (None = the card, raising
    #: when there is none)
    device: object = None

    params: dict = field(init=False)
    opt_state: adamw.AdamWState = field(init=False)
    monitor: Monitor = field(init=False)
    control: ControlPlane | None = field(init=False, default=None)
    detector: FalconDetect | None = field(init=False, default=None)
    history: list[StepRecord] = field(init=False, default_factory=list)
    allocation: list[int] = field(init=False)
    #: host seconds of each step's model work (synchronised with the device)
    step_seconds: list[float] = field(init=False, default_factory=list)
    _wall: float = field(init=False, default=0.0)

    def __post_init__(self) -> None:
        self._device = resolve_device(self.device)
        self.params = model_lib.init_params(self.cfg, self.seed, device=self._device)
        self.opt_state = adamw.init(self.params)
        # The monitor logs on the trainer's simulated wall clock, so comm
        # events and control-plane events share one timebase.
        self.monitor = Monitor(clock=lambda: self._wall)
        self.ckpt = CheckpointManager(self.ckpt_dir)
        self.allocation = [self.data.slots] * self.data.dp_groups
        if self.perf_model is not None:
            self.control = ControlPlane(fleet_kwargs={"device": self._device})
            self._job = self.control.register_job(
                "train",
                self.perf_model,
                detector=FalconDetect(cluster=self.perf_model, verify_window=8,
                                      device=self._device),
                overheads=dict(self.overheads),
                injector=self.injector,
            )
            self.detector = self._job.detector
        self._step_fn = ts_lib.make_train_step(self.cfg, self.opt_cfg)

    @property
    def planner(self):
        """The active event's mitigation planner (None when healthy)."""
        return self._job.planner if self.control is not None else None

    # ------------------------------------------------------------------
    def _observed_iter_time(self, measured: float, now: float) -> float:
        if self.perf_model is None:
            return measured
        if self.injector is not None:
            self.injector.apply(self.perf_model.state, now)
        return self.perf_model.iteration_time()

    def _apply_strategy(self, strategy: Strategy, event) -> None:
        """Deprecated: dispatch through the control-plane strategy registry
        (kept as a shim for pre-control-plane callers)."""
        warnings.warn(
            "FalconTrainer._apply_strategy is deprecated; strategies are "
            "dispatched through repro_torch.controlplane.StrategyRegistry",
            DeprecationWarning,
            stacklevel=2,
        )
        if self.control is None:
            return
        outcome = self._job.registry.dispatch(
            strategy,
            MitigationContext(
                adapter=self.perf_model, event=event, now=self._wall,
                job_id="train", injector=self.injector,
            ),
        )
        self._mirror_result(
            MitigationResult(
                job_id="train", time=self._wall, strategy=strategy,
                applied=outcome.applied, detail=outcome.detail,
            )
        )

    def _mirror_result(self, ev: MitigationResult) -> None:
        """Reflect a strategy's modeled effects into the trainer's state."""
        counts = ev.detail.get("allocation")
        if counts is not None and len(counts) == self.data.dp_groups:
            self.allocation = list(counts)
        if ev.strategy is Strategy.CKPT_AND_RESTART and ev.applied:
            # In-memory checkpoint restore (fast path, Fig. 19 'M'); the
            # modeled side (simulator restart + injection relief) already
            # ran inside CkptRestartStrategy.
            self.ckpt.save_memory(self.params)
            self.params = self.ckpt.restore_memory()
            self.allocation = [self.data.slots] * self.data.dp_groups

    def _sync(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    # ------------------------------------------------------------------
    def run(self, num_steps: int) -> list[StepRecord]:
        for step in range(num_steps):
            batch = {
                k: torch.as_tensor(v, device=self._device)
                for k, v in make_batch(self.cfg, self.data, step).items()
            }
            self._sync()
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch
            )
            loss = float(metrics["loss"])
            self._sync()
            measured = time.monotonic() - t0
            self.step_seconds.append(measured)

            iter_time = self._observed_iter_time(measured, self._wall)
            self._wall += iter_time
            for ev in (
                self.perf_model.emit_events(self._wall - iter_time, iter_time)
                if self.perf_model
                else []
            ):
                self.monitor.extend([ev])

            strategy_applied: str | None = None
            if self.falcon_enabled and self.control is not None:
                for ev in self.control.observe("train", iter_time, self._wall):
                    if not isinstance(ev, MitigationResult):
                        continue
                    if ev.kind == "relief":
                        # Relief: re-balance micro-batches for the recovered
                        # cluster (S2 with a healthy profile = even split).
                        self._mirror_result(ev)
                        strategy_applied = "REBALANCE"
                    else:
                        self._mirror_result(ev)
                        self._wall += ev.overhead
                        strategy_applied = strategy_label(ev.strategy)

            self.history.append(
                StepRecord(
                    step=step,
                    loss=loss,
                    iter_time=iter_time,
                    wall_time=self._wall,
                    strategy=strategy_applied,
                )
            )
        return self.history


# ---------------------------------------------------------------- S3 util
def remap_mesh(mesh, perm: list[int]):
    """Runtime analogue of the paper's node swap: the DeviceMesh whose
    position i holds the rank at position ``perm[i]`` of ``mesh`` (state must
    be redistributed by the caller). Every rank of the process group must
    call it: it builds the new mesh's process groups."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = mesh.mesh.reshape(-1)[torch.as_tensor(perm, dtype=torch.long)]
    return DeviceMesh(mesh.device_type, ranks.reshape(mesh.mesh.shape),
                      mesh_dim_names=mesh.mesh_dim_names)
