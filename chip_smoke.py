#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds both CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``
into ``build/repro_torch_kernels/``, holds each against its plain PyTorch
version on the card, drives the port's paths through their public entry
points, times the kernels and prints one line per phase. Phases, in order:

1. environment: torch version, card name and power limit (``nvidia-smi``);
2. build: both kernels, in parallel, with the build seconds;
3. kernel vs plain version on the card: ``bocd_step`` at K = 32,
   B = 16,384 over 60 ticks (a step change and a NaN column) and
   ``cell_reduce`` at (8, 160, 8) and (2, 2, 2), in float32 and float64;
4. the fleet screen: ``FleetDetect(n_workers=16384)`` on the ``cuda``
   backend for 200 ticks, flags identical to the numpy ``batched`` backend;
5. the pipeline (the main path): ``ControlPlane.tick`` over a
   10,240-device ``TrainingSimulator`` with one GPU throttled, both kernels
   launched, Flag / Diagnosis / Mitigation events identical to the float64
   numpy run on the CPU;
6. times: median CUDA-event time per call of each kernel and of its plain
   version at the path's shapes, beside the bound.

Any failure exits non-zero. The last two lines are a JSON object with one
entry per kernel and ``{"ok": true, "device": {...}}``. The script imports
neither jax nor the JAX package: the card's machine has neither.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks (dense, no sparsity) used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Tolerances of kernel vs plain version, both on the card. float64: the two
# differ only in summation order and library rounding. float32: last-ulp
# differences of exp/log and of the column sums.
TOL = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-6)}  # (rtol, atol)

# The main path's sizes: the fleet screen at 16,384 streams and the
# pipeline over a 10,240-device job (the documented 10k-device run).
FLEET_WORKERS, FLEET_TICKS = 16384, 200
PIPELINE_TICKS = 400


class SmokeError(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1
def phase_env(torch) -> str:
    need(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    need(bool(smi), "nvidia-smi printed no card")
    card = smi[0].strip()
    log(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    log(card)
    return card


# ------------------------------------------------------------------ phase 2
def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all(["bocd_step", "cell_reduce"], verbose=True)
    secs = time.perf_counter() - t0
    for name, out in logs.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        log(f"[2 build] {name}: " + (" | ".join(regs) or "built"))
    log(f"[2 build] both kernels built in {secs:.2f} s (parallel nvcc)")


# ------------------------------------------------------------------ phase 3
def _compare(name, got, want, dtype_name, log_trunc=None):
    """Max abs error of ``got`` vs ``want`` under the dtype's tolerance.

    NaN must sit at the same places. Where ``log_trunc`` is given (the
    log_r output), an entry that is -inf in one and finite in the other is
    allowed only when the finite value is within 1e-4 of log(truncation):
    the truncation test can flip there. In such a column the renormalize
    moved at most the flipped mass, so its other entries may differ by that
    much beyond the tolerance.
    """
    import torch

    rtol, atol = TOL[dtype_name]
    g = got.to(torch.float64)
    w = want.to(torch.float64)
    need(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
    nan_g, nan_w = torch.isnan(g), torch.isnan(w)
    need(bool(torch.equal(nan_g, nan_w)), f"{name}: NaN positions differ")
    inf_g, inf_w = torch.isinf(g), torch.isinf(w)
    mismatch = inf_g != inf_w
    slack = torch.zeros_like(g)
    n_flip = 0
    if bool(mismatch.any()):
        need(log_trunc is not None, f"{name}: infinite/finite mismatch")
        finite = torch.where(inf_g, w, g)[mismatch]
        need(bool(((finite - log_trunc).abs() <= 1e-4).all()),
             f"{name}: -inf/finite mismatch away from the truncation boundary")
        n_flip = int(mismatch.sum())
        cols = mismatch.any(dim=0, keepdim=True)
        flipped_mass = torch.where(mismatch, torch.exp(finite.new_full((), log_trunc)),
                                   torch.zeros_like(g)).sum(dim=0, keepdim=True)
        slack = torch.where(cols, 2.0 * flipped_mass, slack)
    both = ~(nan_g | inf_g | inf_w)
    same_inf = inf_g & inf_w
    need(bool(torch.equal(g[same_inf], w[same_inf])), f"{name}: infinities differ in sign")
    diff = (g - w).abs()
    ok = diff <= atol + rtol * w.abs() + slack
    bad = both & ~ok
    if bool(bad.any()):
        raise SmokeError(
            f"{name}: {int(bad.sum())} entries outside rtol={rtol} atol={atol}; "
            f"max abs err {float(diff[bad].max()):.3e}")
    err = float(diff[both].max()) if bool(both.any()) else 0.0
    return err, n_flip


def _bocd_inputs(np, b, ticks, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (ticks, b))
    x[ticks // 2:, ::97] += 6.0   # step change on every 97th stream
    if b > 1:
        x[ticks // 3:, 123 % b] = np.nan   # one stream goes NaN
    return x


def _bocd_init(torch, np, x0, k, dtype, dev):
    b = x0.size
    log_r = np.full((k, b), -np.inf)
    log_r[0] = 0.0
    t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a)).to(dev, dt)  # noqa: E731
    return (t(log_r), t(np.broadcast_to(x0, (k, b))), t(np.ones((k, b))),
            t(np.ones((k, 1))), t(np.ones((k, 1))),
            t(np.zeros((k, 1)), torch.int32)), t(x0)


def phase_kernels(torch, np):
    from repro_torch.kernels.bocd_step import bocd_step, bocd_step_reference
    from repro_torch.kernels.cell_reduce import cell_reduce, cell_reduce_reference

    dev = torch.device("cuda")
    hazard, trunc = 1.0 / 100.0, 1e-6
    k, ticks = 32, 60
    errs = {}
    names = ("log_r", "mu", "beta", "kappa", "alpha", "rl", "p0")
    for b, dt_name in ((16384, "float32"), (16384, "float64"), (1, "float32")):
        x = _bocd_inputs(np, b, ticks)
        dt = getattr(torch, dt_name)
        state, mu0 = _bocd_init(torch, np, x[0], k, dt, dev)
        log_trunc = float(torch.log(torch.tensor(trunc, dtype=dt)))
        worst = {n: 0.0 for n in names}
        flips = 0
        for i in range(ticks):
            xt = torch.as_tensor(x[i]).to(dev, dt)
            got = bocd_step(xt, *state, mu0, hazard, 1.0, 1.0, 1.0, trunc)
            want = bocd_step_reference(xt, *state, mu0, hazard, 1.0, 1.0, 1.0, trunc)
            torch.cuda.synchronize()
            for n, g, w in zip(names, got, want):
                e, f = _compare(f"bocd_step {dt_name} tick {i} {n}", g, w, dt_name,
                                log_trunc if n == "log_r" else None)
                worst[n] = max(worst[n], e)
                flips += f
            state = want[:6]
        if b > 1:
            nan_col = 123 % b
            need(bool(torch.isnan(state[0][:, nan_col]).all()),
                 "bocd_step: the NaN stream did not stay NaN")
            need(not bool(torch.isnan(state[0][:, nan_col + 1]).any()),
                 "bocd_step: NaN leaked into a neighbouring stream")
        errs[("bocd_step", dt_name, b)] = max(worst.values())
        log(f"[3 kernels] bocd_step {dt_name} K={k} B={b} {ticks} ticks: max abs err "
            f"log_r {worst['log_r']:.3e} p0 {worst['p0']:.3e} mu {worst['mu']:.3e} "
            f"beta {worst['beta']:.3e}; truncation-boundary flips {flips}")

    for shape in ((8, 160, 8), (2, 2, 2)):
        arrays, consts, want64 = _cells_of(np, shape)
        for dt_name in ("float32", "float64"):
            dt = getattr(torch, dt_name)
            ins = [torch.as_tensor(a).to(dev, dt) for a in arrays]
            got = cell_reduce(*ins, *consts)
            want = cell_reduce_reference(*ins, *consts)
            torch.cuda.synchronize()
            worst = 0.0
            for n, g, w in zip(("t", "stage_max", "tp_bw", "dp_bw"), got, want):
                e, _ = _compare(f"cell_reduce {dt_name} {shape} {n}", g, w, dt_name)
                worst = max(worst, e)
            rel_sim = abs(float(got[0]) - want64) / want64
            need(rel_sim <= (1e-12 if dt_name == "float64" else 1e-5),
                 f"cell_reduce {dt_name} {shape}: t off the simulator's numpy "
                 f"result by {rel_sim:.3e}")
            errs[("cell_reduce", dt_name, shape)] = worst
            log(f"[3 kernels] cell_reduce {dt_name} pp,dp,tp={shape}: max abs err vs "
                f"plain {worst:.3e}; t rel err vs numpy simulator {rel_sim:.3e}")
    return errs


def _sim_10k(reduction, device=None):
    from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
    from repro_torch.cluster.spec import ClusterSpec, ModelSpec

    return TrainingSimulator(
        cluster=ClusterSpec(n_nodes=1280),
        job=JobSpec(model=ModelSpec(layers=40, hidden=5120, seq_len=2048,
                                    vocab=50257),
                    tp=8, dp=160, pp=8, micro_batches=320),
        reduction=reduction, device=device,
    )


def _cells_of(np, shape):
    """Measured cell arrays of a faulted simulator of ``shape`` (pp, dp, tp)
    and its float64 numpy iteration time."""
    from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
    from repro_torch.cluster.spec import ClusterSpec, ModelSpec

    pp, dp, tp = shape
    if shape == (8, 160, 8):
        sim = _sim_10k("vectorized")
    else:
        sim = TrainingSimulator(
            cluster=ClusterSpec(n_nodes=1),
            job=JobSpec(model=ModelSpec(layers=8, hidden=1024, seq_len=1024,
                                        vocab=32000),
                        tp=tp, dp=dp, pp=pp, micro_batches=4 * dp),
            reduction="vectorized",
        )
    rng = np.random.default_rng(7)
    n = sim.job.n_devices
    for d in rng.choice(n, max(1, n // 500), replace=False):
        sim.state.devices[int(d)].compute_speed = float(rng.uniform(0.3, 0.9))
    sim.state.degrade_nic(0, 0.5)
    want64 = sim.iteration_time()
    c = sim._cells()
    arrays = (c.cell_speed, c.tp_edge, c.dp_edge, c.hop_bw, sim._alloc_off())
    consts = (c.c_flops, c.c_speed, c.c_tp, c.pp_vol, c.c_dp)
    return arrays, consts, want64


# ------------------------------------------------------- phases 4 and 5
def _fleet_traces(np, n_workers, n_ticks, seed=0):
    """(T, B) iteration times: healthy jitter + 2 % of workers slowed x1.4
    from mid-run (the fleet-scale benchmark's generator)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 0.01, (n_ticks, n_workers))
    bad = rng.choice(n_workers, max(1, n_workers // 50), replace=False)
    x[n_ticks // 2:, bad] *= 1.4
    return x


def _fleet_flags(fleet, x):
    return {(f.worker, f.change_point.index)
            for t in range(x.shape[0]) for f in fleet.tick(x[t])}


def _event_key(ev):
    from repro_torch.controlplane import Diagnosis, Flag, MitigationAction, MitigationResult
    from repro_torch.core.events import strategy_label

    lbl = lambda s: None if s is None else strategy_label(s)  # noqa: E731
    base = (type(ev).__name__, ev.job_id, ev.time)
    if isinstance(ev, Flag):
        return base + (ev.change_point.index,)
    if isinstance(ev, Diagnosis):
        e = ev.event
        return base + (e.root_cause.name, tuple(e.components), e.hang,
                       ev.resolved, ev.deduped_from)
    if isinstance(ev, MitigationAction):
        return base + (lbl(ev.strategy), ev.event.root_cause.name,
                       tuple(ev.event.components))
    if isinstance(ev, MitigationResult):
        return base + (lbl(ev.strategy), ev.applied, ev.kind, ev.status, ev.attempt)
    return None


def _run_pipeline(np, ticks, *, screening_backend, reduction, device=None):
    from repro_torch.cluster.injector import FailSlowInjector, Injection, InjectionKind
    from repro_torch.controlplane import ControlPlane

    dt = 5.0   # the single_gpu_throttle preset's tick
    sim = _sim_10k(reduction, device)
    injector = FailSlowInjector([Injection(
        start=150 * dt, duration=250 * dt, kind=InjectionKind.GPU_SLOW,
        target=(3,), severity=0.5,
    )])
    plane = ControlPlane(screening_backend=screening_backend,
                         fleet_kwargs={"device": device})
    plane.register_job("job", sim, injector=injector, sample_period=dt)
    rng = np.random.default_rng(0)
    keys = []
    for tick in range(ticks):
        now = tick * dt
        injector.apply(sim.state, now)
        sample = sim.iteration_time() * float(rng.normal(1.0, 0.003))
        for ev in plane.tick({"job": sample}, (tick + 1) * dt):
            k = _event_key(ev)
            if k is not None:
                keys.append(k)
    return keys, sim


def phase_references(np):
    """The CPU float64 numpy runs the main path is held to (no kernels)."""
    from repro_torch.core.detector import FleetDetect

    x = _fleet_traces(np, FLEET_WORKERS, FLEET_TICKS)
    t0 = time.perf_counter()
    fleet = _fleet_flags(FleetDetect(n_workers=FLEET_WORKERS, backend="batched"), x)
    fleet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events, _ = _run_pipeline(np, PIPELINE_TICKS, screening_backend="batched",
                              reduction="vectorized", device="cpu")
    pipe_s = time.perf_counter() - t0
    kinds = sorted({k[0] for k in events})
    need("Diagnosis" in kinds and "MitigationAction" in kinds,
         f"the reference pipeline raised no diagnosis/mitigation (kinds {kinds})")
    return {"x": x, "fleet": fleet, "fleet_s": fleet_s, "events": events,
            "pipe_s": pipe_s}


def phase_main_path(torch, np, card, ref):
    """The main path on the card, through the default entry points: the
    fleet screen at 16,384 streams, then the pipeline at 10,240 devices.
    Launch counts are zeroed just before and read just after."""
    from repro_torch.core.detector import FleetDetect
    from repro_torch.kernels.bocd_step import bocd_step
    from repro_torch.kernels.cell_reduce import cell_reduce

    fleet = FleetDetect(n_workers=FLEET_WORKERS)      # default backend: the kernel
    need(fleet._backend.name == "cuda", f"default backend is {fleet._backend.name}")
    torch.cuda.synchronize()
    bocd_step.launches = 0
    cell_reduce.launches = 0
    t0 = time.perf_counter()
    flags = _fleet_flags(fleet, ref["x"])
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    fleet_launches = bocd_step.launches
    t0 = time.perf_counter()
    events, sim = _run_pipeline(np, PIPELINE_TICKS, screening_backend=None,
                                reduction="auto")
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    launches = {"bocd_step": bocd_step.launches, "cell_reduce": cell_reduce.launches}

    need(fleet_launches > 0, "the fleet screen launched no bocd_step kernel")
    want = ref["fleet"]
    need(flags == want, f"fleet flags differ: {len(flags - want)} only on cuda, "
                        f"{len(want - flags)} only on batched")
    log(f"[4 fleet] FleetDetect n_workers={FLEET_WORKERS} ticks={FLEET_TICKS}: "
        f"{len(flags)} flags, identical to the CPU batched backend; cuda "
        f"{FLEET_TICKS / fleet_s:.1f} ticks/s (CPU batched "
        f"{FLEET_TICKS / ref['fleet_s']:.1f} ticks/s); bocd_step launches "
        f"{fleet_launches}; card: {card}")

    need(type(sim._reduction_backend()).__name__ == "CudaReduction",
         "the simulator did not resolve to the CUDA reduction")
    pipe_launches = {"bocd_step": launches["bocd_step"] - fleet_launches,
                     "cell_reduce": launches["cell_reduce"]}
    for name, n in pipe_launches.items():
        need(n > 0, f"the pipeline launched no {name} kernel")
    want = ref["events"]
    if events != want:
        diff = [(a, b) for a, b in zip(events, want) if a != b][:3]
        raise SmokeError(
            f"pipeline events differ ({len(events)} vs {len(want)}): {diff}")
    diag = [k for k in want if k[0] == "Diagnosis"]
    acts = [k[3] for k in want if k[0] == "MitigationAction"]
    log(f"[5 pipeline] ControlPlane.tick x{PIPELINE_TICKS} on tp=8 dp=160 pp=8 "
        f"(10,240 devices): {len(want)} Flag/Diagnosis/Mitigation events identical "
        f"to the CPU float64 run; first diagnosis {diag[0][3:5] if diag else None}; "
        f"strategies {acts}; launches {pipe_launches}; "
        f"{PIPELINE_TICKS / pipe_s:.1f} ticks/s on the card path, "
        f"{PIPELINE_TICKS / ref['pipe_s']:.1f} on the CPU path")
    log(f"[main path] launches over the fleet screen and the pipeline: {launches}")
    return launches


# ------------------------------------------------------------------ phase 6
def _device_ms(torch, fn, runs=100, chunk=10):
    """Median device time of ``fn()`` over ``runs`` calls. Each chunk of
    calls is queued behind a sleeping kernel long enough to cover the host's
    enqueue time, so each event pair brackets device work only."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunk):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # Calibrate the sleep kernel's cycles per second.
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_s = 10_000_000 / (a.elapsed_time(b) / 1e3)
    times = []
    while len(times) < runs:
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(chunk)]
        torch.cuda._sleep(int(3.0 * host_s * cycles_per_s))
        for s, e in evs:
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times += [s.elapsed_time(e) for s, e in evs]
    return statistics.median(times), host_s / chunk * 1e3


def phase_times(torch, np, card, errs, launches):
    from repro_torch.kernels.bocd_step import bocd_step, bocd_step_reference
    from repro_torch.kernels.cell_reduce import cell_reduce, cell_reduce_reference

    dev = torch.device("cuda")
    out = []
    # bocd_step at the fleet screen's shape, float32.
    k, b = 32, 16384
    x = _bocd_inputs(np, b, 2)
    state, mu0 = _bocd_init(torch, np, x[0], k, torch.float32, dev)
    xt = torch.as_tensor(x[1]).to(dev, torch.float32)
    args = (xt, *state, mu0, 0.01, 1.0, 1.0, 1.0, 1e-6)
    saved = bocd_step.launches
    ms, call_ms = _device_ms(torch, lambda: bocd_step(*args))
    plain_ms, plain_call_ms = _device_ms(torch, lambda: bocd_step_reference(*args))
    bocd_step.launches = saved
    nbytes = 4 * (6 * k * b + 3 * b + 6 * k)   # state, x, mu0, p0, (K,1) vectors
    flops = 45 * k * b                          # ~45 operations per (slot, stream)
    out.append(_row("bocd_step", "src/repro_torch/kernels/csrc/bocd_step.cu",
                    "src/repro/kernels/bocd_step.py:179", launches["bocd_step"],
                    errs[("bocd_step", "float32", 16384)], ms, plain_ms, nbytes, flops))
    log(f"[6 times] bocd_step f32 K={k} B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(device, median of >=100); per call with host {call_ms:.4f} / "
        f"{plain_call_ms:.4f} ms; bound {out[-1]['bound_ms']:.4f} ms ({out[-1]['bound_by']}); "
        f"card: {card}")
    # The pipeline's screen is one stream wide: the same step at B = 1.
    x1 = _bocd_inputs(np, 1, 2)
    state1, mu01 = _bocd_init(torch, np, x1[0], k, torch.float32, dev)
    args1 = (torch.as_tensor(x1[1]).to(dev, torch.float32), *state1, mu01,
             0.01, 1.0, 1.0, 1.0, 1e-6)
    saved = bocd_step.launches
    ms1, call1 = _device_ms(torch, lambda: bocd_step(*args1))
    plain1, plain_call1 = _device_ms(torch, lambda: bocd_step_reference(*args1))
    bocd_step.launches = saved
    log(f"[6 times] bocd_step f32 K={k} B=1 (the pipeline's screen): kernel {ms1:.4f} ms, "
        f"plain {plain1:.4f} ms (device, median of >=100); per call with host "
        f"{call1:.4f} / {plain_call1:.4f} ms; card: {card}")
    # cell_reduce at the 10,240-device job, float32.
    arrays, consts, _ = _cells_of(np, (8, 160, 8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        ins = [torch.as_tensor(a).to(dev, torch.float32) for a in arrays]
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) / 20 * 1e3
    copy_bytes = sum(a.nbytes for a in arrays)
    saved = cell_reduce.launches
    ms, call_ms = _device_ms(torch, lambda: cell_reduce(*ins, *consts))
    plain_ms, plain_call_ms = _device_ms(torch, lambda: cell_reduce_reference(*ins, *consts))
    cell_reduce.launches = saved
    pp, dp, tp = 8, 160, 8
    n_in = pp * dp + 2 * pp * dp * tp + (pp - 1) * dp + dp
    n_out = 1 + dp + pp * dp + pp * tp
    nbytes = 4 * (n_in + n_out)
    flops = 2 * pp * dp * tp + 4 * pp * dp + 2 * (pp - 1) * dp + 3 * dp
    out.append(_row("cell_reduce", "src/repro_torch/kernels/csrc/cell_reduce.cu",
                    "src/repro/kernels/cell_reduce.py:87", launches["cell_reduce"],
                    errs[("cell_reduce", "float32", (8, 160, 8))], ms, plain_ms,
                    nbytes, flops))
    log(f"[6 times] cell_reduce f32 pp,dp,tp=(8,160,8): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (device, median of >=100); per call with host "
        f"{call_ms:.4f} / {plain_call_ms:.4f} ms; bound {out[-1]['bound_ms']:.6f} ms "
        f"({out[-1]['bound_by']}); host-to-device copy of the cells "
        f"({copy_bytes} B float64 in, cast to float32) {copy_ms:.4f} ms; card: {card}")
    return out


def _row(name, source, replaces, launches, err, ms, plain_ms, nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        card = phase_env(torch)
        phase_build()
        errs = phase_kernels(torch, np)
        launches = phase_main_path(torch, np, card, phase_references(np))
        rows = phase_times(torch, np, card, errs, launches)
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro")
        need(not leaked, f"modules of jax or the JAX package were loaded: {leaked[:5]}")
    except SmokeError as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        return 1
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
