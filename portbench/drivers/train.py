"""The training driver: ``FalconTrainer`` from the port, watched by FALCON.

Set-up builds one trainer: the port's model at the configuration's sizes, its
AdamW state, and FALCON's control plane watching the configuration's modelled
job through the port's performance model with the traffic's fail-slow trace.
The benchmark draws the weights from the seed and hands them to the trainer.
Set-up then takes the traffic's first steps (three) through the window's own
call, each on its own batch, and reads what the comparison needs: each
step's loss, the first gradient as AdamW holds it after one step (its first
moment over 1 - beta1), and each leaf's change after the three steps.

The window repeats the same call, one step at a time, each step on a batch of
its own, until ``seconds`` have passed. A step is ``FalconTrainer.run(1)``:
the batch built on the host and copied, the synchronised model step, the
performance model and FALCON's ``observe``. With ``trace`` the traffic's
``trace_steps`` further steps run under the profiler after the window.

Once the window has closed and the port's state is freed, the reference
follows the first three steps from the same seed, and the gaps are held to
the cell's limits. FALCON's events over the whole run are held to what the
reference works out from the traffic's fail-slow trace
(:mod:`portbench.reference.events`), and counted by kind in the result.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from portbench import bench, trace as trace_lib, yardstick
from portbench.drivers.common import (device_entry, end_to_end, finish, peak,
                                      port_config, print_split, sync)
from portbench.reference import events as ref_events, train as ref_train, weights


def data_seed(seed: int, step: int) -> int:
    """The data seed of step ``step`` of a run with ``seed``: every step of
    every run draws rows of its own."""
    return (seed % 2**62) * 65536 + step


class Run:
    """One trainer, from the seed, and what its first steps read."""

    def __init__(self, cell: bench.Cell, seed: int, device, plant=None) -> None:
        from repro_torch.cluster.injector import FailSlowInjector, Injection, InjectionKind
        from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
        from repro_torch.cluster.spec import ClusterSpec, ModelSpec
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.models.model import param_shapes
        from repro_torch.optim import adamw
        from repro_torch.train.trainer import FalconTrainer

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        conf, tr = cell.config, cell.traffic
        self.sz = sz = weights.sizes(conf, cell.root)
        arch = port_config(conf, sz)
        job = conf["deployment"]["watched_job"]
        sim = TrainingSimulator(
            cluster=ClusterSpec(n_nodes=job["n_nodes"], gpus_per_node=job["gpus_per_node"]),
            job=JobSpec(model=ModelSpec(layers=job["layers"], hidden=job["hidden"],
                                        seq_len=job["seq_len"], vocab=job["vocab"]),
                        tp=job["tp"], dp=job["dp"], pp=job["pp"],
                        micro_batches=job["micro_batches"]),
            device=self.device,
        )
        self.unit = unit = sim.healthy_iteration_time()
        kinds = {"gpu": InjectionKind.GPU_SLOW, "link": InjectionKind.LINK_CONGESTION,
                 "nic": InjectionKind.NIC_CONGESTION, "cpu": InjectionKind.CPU_CONTENTION}
        injector = FailSlowInjector([
            Injection(start=e["start"] * unit, duration=e["duration"] * unit,
                      kind=kinds[e["kind"]], target=tuple(e["target"]), severity=e["severity"])
            for e in tr["injections"]])
        self.data = DataConfig(seq_len=tr["seq_len"], global_batch=tr["micro_batch"] * tr["slots"],
                               slots=tr["slots"], dp_groups=1, seed=data_seed(seed, 0))
        self.opt = tr["optimizer"]
        opt_fields = {f.name for f in dataclasses.fields(adamw.AdamWConfig)}
        marks = [("imports, CUDA context, performance model", time.perf_counter())]
        self.trainer = FalconTrainer(
            cfg=arch, data=self.data,
            opt_cfg=adamw.AdamWConfig(**{k: v for k, v in self.opt.items() if k in opt_fields}),
            perf_model=sim, injector=injector, device=self.device)
        # The benchmark's weights replace the trainer's own.
        self.trainer.params = self.trainer.opt_state = None
        gc.collect()
        params = weights.make(sz, seed, self.device)
        want = {p: tuple(t.shape) for p, t in adamw.leaves(param_shapes(arch))}
        got = {p: tuple(t.shape) for p, t in params.items()}
        if want != got:
            raise RuntimeError(f"the port's parameter tree differs from the spec: {want} vs {got}")
        self.trainer.params = weights.nest(params)
        del params
        self.trainer.opt_state = adamw.init(self.trainer.params)
        marks.append(("trainer and weights", time.perf_counter()))
        if plant is not None:
            plant(self.trainer)
        self.steps = 0
        self.tokens_per_step = tr["seq_len"] * tr["micro_batch"] * tr["slots"]
        self.first = self._first_steps(tr["setup_steps"])
        marks.append(("first steps and their readings", time.perf_counter()))
        self.setup_marks = marks

    def step(self) -> None:
        """One step of the window's call, on the rows of its own data seed."""
        self.trainer.data = dataclasses.replace(self.data, seed=data_seed(self.seed, self.steps))
        self.trainer.run(1)
        self.steps += 1

    def _first_steps(self, n: int) -> dict:
        from repro_torch.optim import adamw

        vocab, b1 = self.sz["vocab"], self.opt["beta1"]
        grad_norms = {}
        for i in range(n):
            self.step()
            if i == 0:
                for path, mu in adamw.leaves(self.trainer.opt_state.mu):
                    grad_norms.update(ref_train.norms({path: mu / (1 - b1)}, vocab))
        change = ref_train.change_norms(dict(adamw.leaves(self.trainer.params)), self.sz,
                                        self.seed, self.device)
        return {"losses": [r.loss for r in self.trainer.history[:n]],
                "grad_norms": grad_norms, "change_norms": change}

    def events(self) -> list[dict]:
        """FALCON's events so far, as the plain dicts
        :func:`portbench.reference.events.mismatches` reads."""
        out = []
        for ev in self.trainer.control.events:
            d = {"type": type(ev).__name__, "time": float(ev.time)}
            if d["type"] == "Diagnosis":
                d.update(cause=ev.event.root_cause.value, components=list(ev.event.components))
            elif d["type"] == "MitigationResult":
                alloc = ev.detail.get("allocation")
                d.update(strategy=getattr(ev.strategy, "name", str(ev.strategy)),
                         applied=bool(ev.applied), status=ev.status, kind=ev.kind,
                         allocation=None if alloc is None else [int(a) for a in alloc])
            out.append(d)
        return out

    def event_faults(self) -> list[str]:
        """How FALCON's events so far depart from the reference's."""
        exp = ref_events.expected(self.cell.traffic, self.cell.config["deployment"]["watched_job"])
        return ref_events.mismatches(self.events(), self.trainer.history[-1].wall_time,
                                     self.unit, exp)

    def free(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32", slots_used: int | None = None,
                  state_reset: int | None = None) -> dict:
        tr = self.cell.traffic
        return ref_train.follow(
            self.sz, self.opt, self.seed,
            [data_seed(self.seed, k) for k in range(tr["setup_steps"])],
            tr["slots"], tr["micro_batch"], tr["seq_len"], self.device,
            precision=precision, slots_used=slots_used, state_reset=state_reset)


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device, t0: float,
        plant=None) -> dict:
    """One run of a training cell: the result line's fields, ``checks`` last."""
    device = torch.device(device)
    r = Run(cell, seed, device, plant=plant)
    sync(device)
    setup_peak = peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    n_setup, hist0 = r.steps, len(r.trainer.step_seconds)
    # Set-up's objects out of the collector's way: a window's collections
    # walk only what the window makes.
    gc.collect()
    gc.freeze()
    start = time.perf_counter()
    setup_s = start - t0
    print_split(t0, r.setup_marks)
    walls = []
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        r.step()
        walls.append(time.perf_counter() - t)
    window_s = time.perf_counter() - start
    gc.unfreeze()
    print("window steps (s, host clock):", " ".join(f"{w:.4f}" for w in walls), file=sys.stderr)
    steps = r.steps - n_setup
    step_s = sum(r.trainer.step_seconds[hist0:])
    losses = [h.loss for h in r.trainer.history[n_setup:]]
    window_peak = peak(device)
    traced = None
    if trace:
        traced = trace_lib.profile(
            lambda: [r.step() for _ in range(cell.traffic["trace_steps"])])
    peak_bytes = max(setup_peak, window_peak, peak(device))
    first = r.first
    kinds = {}
    for ev in r.events():
        kinds[ev["type"]] = kinds.get(ev["type"], 0) + 1
    event_faults = r.event_faults()
    for f in event_faults:
        print("FALCON event fault:", f, file=sys.stderr)
    r.free()
    gaps = ref_train.compare(first, r.reference())
    gaps["event_mismatches"] = len(event_faults)
    checks = {k: {"value": gaps[k], "limit": lim} for k, lim in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    flops = yardstick.train_step_flops(r.sz, cell.traffic["seq_len"],
                                       cell.traffic["micro_batch"] * cell.traffic["slots"])
    ctx = {"driver": "train", "steps": steps, "window_s": window_s, "step_s": step_s,
           "flops_per_step": flops, "tokens_per_step": r.tokens_per_step,
           "window_peak_bytes": window_peak, "trace": traced,
           "trace_units": cell.traffic["trace_steps"]}
    if trace:
        metrics = bench.per_layer_metrics(cell, ctx)
    else:
        metrics = end_to_end(cell, setup_s, steps * r.tokens_per_step / window_s)
    out = {"correct": correct, "attempted": steps,
           "failed": sum(1 for x in losses if not math.isfinite(x)),
           "metrics": metrics, "device": device_entry(device, cell.chips, peak_bytes),
           "events": kinds}
    return finish(out, traced, checks)


def study(cell: bench.Cell, seed: int, device, controls: bool) -> list[dict]:
    """The readings a cell's limits are set from: the port's gaps and, with
    ``controls``, those of the fp8 control, of a batch cut to its first half
    and, where the architecture scans in chunks (its ``state_reset``), of a
    scan whose state does not cross between them, each put in the port's
    place, against the float32 reference."""
    r = Run(cell, seed, device)
    first = r.first
    r.free()
    ref = r.reference()
    out = [{"side": "port", **ref_train.compare(first, ref), "losses": first["losses"],
            "ref_losses": ref["losses"]}]
    if controls:
        out.append({"side": "control_fp8", **ref_train.compare(r.reference(precision="fp8"), ref)})
        half = cell.traffic["slots"] // 2
        out.append({"side": "fault_half_batch",
                    **ref_train.compare(r.reference(slots_used=half), ref)})
        chunk = r.sz["arch"].state_reset(r.sz)
        if chunk:
            out.append({"side": "fault_state_reset",
                        **ref_train.compare(r.reference(state_reset=chunk), ref)})
    return out
