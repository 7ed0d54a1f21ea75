#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the five CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` into ``build/repro_torch_kernels/``, holds each against its plain
PyTorch version on the card, drives the port's paths through their public
entry points, times the kernels and prints one line per phase. Phases, in
order:

1. environment: torch version, card name and power limit (``nvidia-smi``);
2. build: the five kernels, in parallel, with the build seconds; the bf16
   attention's machine code holds tensor-core instructions (HGMMA) fed by
   TMA loads, and so does the SSD scan's;
3. kernel vs plain version on the card: ``bocd_step`` at K = 32,
   B = 16,384, 1 and 1,000, and at K = 256 (FleetDetect's adaptive cap),
   B = 16,384 and 1,000, over 60 ticks (a step change and a NaN column) and
   ``cell_reduce`` at (8, 160, 8), (2, 2, 2), (16, 128, 8) and
   (16, 1024, 8), in float32 and float64, through both entries (the packed
   one on float64 cells equal bit for bit to the kernel on copies of the
   arithmetic type), and with one NaN TP edge;
   ``flash_decode`` (GQA rep 4, MQA, per-sequence lengths, valid_len 1 and
   0, a cache length off the split grid) and ``flash_attention`` (causal,
   non-causal, a window, a ragged Sq) in float32 and bfloat16; ``ssd_scan``
   (the reference's three test shapes, two groups included, and the
   mamba2-2.7b forward shape, also with a dt 100x smaller that carries the
   state through every chunk) in float32 and bfloat16, y and final state,
   each bf16 row of y also held to a relative L2 error beside the reading
   of a plain version that drops the state entering one chunk;
   boundary sweeps of ``flash_attention`` (Sq = Skv around every tile edge,
   three masks, hd 64/128, three GQA ratios) and ``flash_decode``
   (``valid_len`` across the split and cluster edges, as ints and per
   sequence, hd 32/64/128); bf16 attention rows also held to a relative
   L2 error, beside the reading of a kernel that left out one key tile;
4. the fleet screen: ``FleetDetect(n_workers=16384)`` on the ``cuda``
   backend for 200 ticks, flags identical to the numpy ``batched`` backend;
5. the pipeline (slice 1's main path): ``ControlPlane.tick`` over a
   10,240-device ``TrainingSimulator`` with one GPU throttled, both kernels
   launched, Flag / Diagnosis / Mitigation events identical to the float64
   numpy run on the CPU;
6. serving (slice 2's main path): ``repro_torch.launch.serve.serve`` with
   granite-3-8b at its published width, ``use_kernel``, 8 requests x
   (1,024 prompt + 64 generated) and ``gpu:1:0.5:5:200`` injected:
   ``flash_decode`` launched 40 x 64 times, finite logits, the FALCON onset
   of a CPU run of the same latency loop (token 36, gpu_degradation on
   gpu:1);
7. forward: ``model.forward(use_kernel=True)`` over a 4,096-token prompt,
   ``flash_attention`` launched 40 times, its bf16 logits' difference from
   the plain blocked attention reported;
8. times: median CUDA-event time per call of each kernel, of its plain
   version and, where one PyTorch call computes the same function, of
   that call, at the paths' shapes, beside the bound, with its rate and its
   ratios to that call and to the bound; the CUDA kernels of one
   ``bocd_step`` call (torch.profiler), its time held to BOCD_GATE_MS;
   ``cell_reduce`` on the packed float64 cells at (8, 160, 8) (held to
   CELL_GATE_MS) and (16, 128, 8) beside an empty launch, and one simulator
   evaluation with the host included, the packed route (one upload, one
   launch, one download) against the unpacked one in turns, held to
   EVAL_RATIO;
9. parity at the published width, kernel route against plain route:
   teacher-forced decode on the same caches and the 4,096-token forward;
   bf16 differences reported, float32 (weights upcast exactly) held to a
   tolerance. granite-3-8b's tensors are released after it;
10. the mamba2-2.7b forward (slice 3's forward path) at its published width
    over 4,096 tokens: ``ssd_scan`` launched once per layer (64), faster
    than the plain chunked SSD, the two routes' logits in bf16 reported,
    in float32 held to a tolerance;
11. mamba2-2.7b serving: ``serve`` with 4 requests x (512 prompt + 32
    generated) and ``gpu:1:0.5:1:200``: the FALCON onset of the CPU latency
    loop, and in float32 the teacher-forced decode logits (prefill and the
    recurrence) equal to the kernel forward's at the same positions;
12. training (slice 3's train path): ``FalconTrainer`` on mamba2-2.7b at
    its published width, 30 steps of 2 micro-batches of 4 x 512 tokens, the
    simulator of ``launch/train.py`` with ``gpu:1:0.9:0.5:200`` injected:
    finite losses, the control-plane event log identical to a CPU replay of
    the same simulator, injector and observe loop without the model, with a
    diagnosis and a mitigation in it; seconds per step and peak memory;
13. the SSD scan's times at the forward shape (as phase 8), split by
    kernel (torch.profiler), beside the bound and the design's own floor;
    at most SSD_GATE_MS and faster than the plain chunked route;
14. campaigns (slice 7's main path): ``repro_torch.scenarios.run_and_score``
    on the card with the default backends (the shared-prefix engine, the
    CUDA ``bocd_step`` screen in float32) for each of the eight presets at
    its default jobs and seed 0, held to the committed report
    ``results/campaigns/<preset>-j<n>-s0.json``: equal decisions (type, job,
    time, change point, root cause, components, strategy, status of every
    flag, diagnosis, mitigation action and result), equal ``detection``,
    ``mitigation``, ``episodes`` and ``diagnoses`` blocks, every other float
    within CAMPAIGN_RTOL relative; byte identity reported. Each preset also
    runs on the CPU eager route (numpy backends, independent runs, byte
    identical to the committed report) for its wall seconds; ``bocd_step``
    launches and the host time of the engine's per-tick plane snapshots are
    reported. ``mixed_fleet`` with ``obs=True``: its trace and metrics
    sidecars equal the committed ones byte for byte. A 3-seed
    ``single_gpu_throttle -j1`` sweep over a spawn pool of two workers on
    the card equals ``results/sweeps/single_gpu_throttle-j1-seeds3.json``.

Any failure exits non-zero. The last two lines are a JSON object with one
entry per kernel (``bocd_step``'s also carries ``campaign_launches``, its
launches in phase 14) and ``{"ok": true, "device": {...}}``. The script imports
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
BF16_FLOP_PER_S = 989e12

# Tolerances of kernel vs plain version, both on the card. float64: the two
# differ only in summation order and library rounding. float32: last-ulp
# differences of exp/log and of the column sums.
TOL = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-6)}  # (rtol, atol)

# The main path's sizes: the fleet screen at 16,384 streams and the
# pipeline over a 10,240-device job (the documented 10k-device run).
FLEET_WORKERS, FLEET_TICKS = 16384, 200
PIPELINE_TICKS = 400

# cell_reduce: the pipeline's (pp, dp, tp); (2, 2, 2); the Llama 3 405B
# pretraining layout (16,384 GPUs, TP 8, PP 16, DP 128; arXiv:2407.21783,
# Table 4; 288 KB of float64 cells); and the same at DP 1,024, whose blocks
# take their 128 dp columns in several passes.
# Gates: the kernel's device median at (8, 160, 8) on the packed float64
# cells, and one evaluation with the host included, packed route against
# the unpacked one (five float32 copies, the kernel, cat, .cpu()) in turns.
CELL_SHAPES = ((8, 160, 8), (2, 2, 2), (16, 128, 8), (16, 1024, 8))
CELL_GATE_MS = 0.007
CELL_EARLIER_MS = 0.0139   # the first, one-block design of the kernel, (8, 160, 8) float32
EVAL_RATIO, EVAL_RUNS = 0.5, 60

# Slice 2's paths: granite-3-8b at its published width (40 layers, d_model
# 4096, 32 heads / 8 KV heads of 128), 8 requests x (1,024 prompt + 64
# generated), the fail-slow of the reference CLI's docstring; a forward
# pass over 4,096 tokens.
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN = "granite-3-8b", 8, 1024, 64
SERVE_INJECT = "gpu:1:0.5:5:200"
#: the onset the full-width run must flag: (token, root cause, components)
SERVE_EVENT = (36, "gpu_degradation", ["gpu:1"])
FORWARD_LEN = 4096
TEACHER_STEPS = 8

# Slice 3's paths: mamba2-2.7b at its published width (64 layers, d_model
# 2560, 80 heads of 64, state 128, chunk 128). Serving 4 requests x (512 +
# 32) with a fail-slow that fires inside 32 tokens (the modeled time per
# token is ~0.057 s); training 2 micro-batches of 4 x 512 tokens per step
# with a GPU_SLOW that FALCON diagnoses at step 12 and mitigates at steps
# 12 (S1) and 18 (S2) on the CPU replay.
MAMBA_ARCH = "mamba2-2.7b"
MAMBA_B, MAMBA_PROMPT, MAMBA_GEN = 4, 512, 32
MAMBA_INJECT = "gpu:1:0.5:1:200"
MAMBA_EVENT = (19, "gpu_degradation", ["gpu:1"])
TRAIN_DATA = dict(seq_len=512, global_batch=8, slots=2, dp_groups=2)
TRAIN_INJECT = "gpu:1:0.9:0.5:200"
TRAIN_STEPS = 30

# Tolerances of the attention kernels against their plain versions: the
# reference's (tests/test_kernels.py:17). float32: summation order only;
# bfloat16: both accumulate in float32 and round the result once to bf16.
ATT_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol)
# bfloat16 also holds each output row (the hd values of one query and head)
# to a relative L2 error, ||got - want|| / ||want||: in rows over thousands
# of keys the outputs are of the size of ATT_TOL's atol, so the element-wise
# bound alone would pass a kernel that dropped a tile there. Sound bf16
# rows read a few 1e-3 (P and the output each rounded to bf16); a row
# missing one 128-key tile of n keys reads about sqrt(128 / n), 0.18 at
# n = 4,096. Phase 3 prints both readings at the forward shape.
ATT_ROW_REL = 2e-2
FAULT_TILE = 16   # the key tile the fault reading leaves out (keys 2,048-2,175)
# Model logits, kernel route vs plain route on the same weights and caches,
# held in float32 (weights upcast exactly): there the two routes differ only
# in the attention's summation order (~1e-6 relative per layer). In bf16 one
# rounding of an attention output either way (2^-8 relative) grows through
# 40 random-weight layers to ~0.3 in logits of magnitude ~5 (measured on an
# H100 at this width), so bf16 logits are reported, not held to a
# tolerance. The same growth (~x15 relative) of the float32 differences
# gives ~1e-4; the tolerance leaves ten times that.
PARITY_TOL = (1e-3, 1e-3)  # (rtol, atol), float32
# The SSD scan against its plain version (the sequential recurrence): the
# reference's tolerances (tests/test_kernels.py:98). The mamba2-2.7b logits,
# kernel route vs the plain chunked SSD, are held in float32 to PARITY_TOL
# by the same reckoning: the two scans differ in summation order (~1e-6
# relative per layer; the plain route rounds its scores and chunk states
# only to the activation type, float32 here), grown through 64 layers.
SSD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (3e-2, 3e-2)}  # (rtol, atol)


# Slice 7's path: the eight presets at their default jobs, seed 0 — the
# committed reports. A report's floats that are not decisions or scores
# (flag means, severities, screen tunings) come from the float32 screen
# and are held to the float32 contract of docs/kernels.md.
CAMPAIGNS = (("single_gpu_throttle", 1), ("rack_nic_congestion", 4),
             ("cascading_host_contention", 4), ("long_tail_degradation", 2),
             ("collective_hang", 2), ("flaky_executor", 2), ("failslow_storm", 6),
             ("mixed_fleet", 8))
CAMPAIGN_RTOL = 1e-4
CAMPAIGN_BLOCKS = ("detection", "mitigation", "episodes", "diagnoses")
SWEEP = ("single_gpu_throttle", 1, 3)    # preset, jobs, seeds
SWEEP_WORKERS = 2


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
KERNELS = ("bocd_step", "cell_reduce", "flash_decode", "flash_attention", "ssd_scan")


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all(KERNELS, verbose=True)
    secs = time.perf_counter() - t0
    for name, out in logs.items():
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln and "0 bytes spill" not in ln]
        if len(regs) > 6:
            regs = regs[:6] + [f"... {len(regs) - 6} more lines"]
        log(f"[2 build] {name}: " + (" | ".join(regs) or "built"))
    log(f"[2 build] {len(KERNELS)} kernels built in {secs:.2f} s (parallel nvcc)")
    # The bf16 attention runs on the tensor cores: its library's machine code
    # holds warpgroup matrix instructions (HGMMA) fed by TMA loads.
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"[2 build] flash_attention SASS: {counts['HGMMA']} HGMMA (wgmma), "
        f"{counts['UTMALDG']} UTMALDG (TMA loads)")
    need(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
         f"flash_attention's library lacks tensor-core instructions: {counts}")
    # So does the bf16 SSD scan (wgmma: HGMMA).
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("ssd_scan"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"[2 build] ssd_scan SASS: {counts['HGMMA']} HGMMA (wgmma), {counts['UTMALDG']} "
        f"UTMALDG (TMA loads)")
    need(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
         f"ssd_scan's library lacks tensor-core instructions: {counts}")


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
    from repro_torch.kernels.cell_reduce import (
        blocks_of, cell_reduce, cell_reduce_packed, cell_reduce_reference, out_size, split_out)

    dev = torch.device("cuda")
    hazard, trunc = 1.0 / 100.0, 1e-6
    ticks = 60
    errs = {}
    names = ("log_r", "mu", "beta", "kappa", "alpha", "rl", "p0")
    # K = 256: FleetDetect's adaptive cap at its upper bound, above the 128
    # rows a column's threads hold at a time.
    for k, b, dt_name in ((32, 16384, "float32"), (32, 16384, "float64"), (32, 1, "float32"),
                          (32, 1000, "float64"), (256, 16384, "float32"),
                          (256, 1000, "float64")):
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
        errs[("bocd_step", dt_name, b, k)] = max(worst.values())
        log(f"[3 kernels] bocd_step {dt_name} K={k} B={b} {ticks} ticks: max abs err "
            f"log_r {worst['log_r']:.3e} p0 {worst['p0']:.3e} mu {worst['mu']:.3e} "
            f"beta {worst['beta']:.3e}; truncation-boundary flips {flips}")

    for shape in CELL_SHAPES:
        arrays, consts, want64 = _cells_of(np, shape)
        cells = _packed_cells(torch, np, arrays, shape)
        for dt_name in ("float32", "float64"):
            dt = getattr(torch, dt_name)
            ins = [torch.as_tensor(a).to(dev, dt) for a in arrays]
            got = cell_reduce(*ins, *consts)
            out = torch.empty(out_size(*shape), dtype=dt, device=dev)
            packed = split_out(cell_reduce_packed(cells, shape, *consts, out=out), shape)
            want = cell_reduce_reference(*ins, *consts)
            torch.cuda.synchronize()
            worst = 0.0
            for n, g, p, w in zip(("t", "stage_max", "tp_bw", "dp_bw"), got, packed, want):
                e, _ = _compare(f"cell_reduce {dt_name} {shape} {n}", g, w, dt_name)
                ep, _ = _compare(f"cell_reduce packed {dt_name} {shape} {n}", p, w, dt_name)
                need(bool(torch.equal(p, g)),
                     f"cell_reduce {dt_name} {shape} {n}: the packed entry (float64 cells "
                     f"rounded on load) differs from the kernel on {dt_name} copies")
                worst = max(worst, e, ep)
            rel_sim = abs(float(got[0]) - want64) / want64
            need(rel_sim <= (1e-12 if dt_name == "float64" else 1e-5),
                 f"cell_reduce {dt_name} {shape}: t off the simulator's numpy "
                 f"result by {rel_sim:.3e}")
            errs[("cell_reduce", dt_name, shape)] = worst
            log(f"[3 kernels] cell_reduce {dt_name} pp,dp,tp={shape}: max abs err vs "
                f"plain {worst:.3e} (both entries; packed = kernel on {dt_name} copies, "
                f"bit for bit); t rel err vs numpy simulator {rel_sim:.3e}; "
                f"(blocks, dp columns a block) = {blocks_of(shape[1])}")
    # A NaN TP edge reaches that cell's tp_bw, its column's stage_max and t.
    arrays, consts, _ = _cells_of(np, (8, 160, 8))
    arrays = list(arrays)
    arrays[1] = arrays[1].copy()
    arrays[1][3, 17, 5] = np.nan
    out = torch.empty(out_size(8, 160, 8), dtype=torch.float32, device=dev)
    got = split_out(cell_reduce_packed(_packed_cells(torch, np, arrays, (8, 160, 8)),
                                       (8, 160, 8), *consts, out=out), (8, 160, 8))
    want = cell_reduce_reference(*(torch.as_tensor(a).to(dev, torch.float32) for a in arrays),
                                 *consts)
    for n, g, w in zip(("t", "stage_max", "tp_bw", "dp_bw"), got, want):
        _compare(f"cell_reduce NaN case {n}", g, w, "float32")
    need(bool(got[0].isnan().all()) and int(got[1].isnan().sum()) == 1
         and bool(got[1][0, 17].isnan()) and int(got[2].isnan().sum()) == 1
         and bool(got[2][3, 17].isnan()) and not bool(got[3].isnan().any()),
         "cell_reduce: a NaN TP edge did not reach exactly its tp_bw, stage_max and t")
    log("[3 kernels] cell_reduce float32 (8,160,8) with one NaN TP edge: NaN in its tp_bw, "
        "its column's stage_max and t only, as the plain version")
    return errs


def _att_err(torch, name, got, want, dt_name, tol=ATT_TOL):
    """Max abs error of a model kernel against its plain version under
    ``tol`` (``ATT_TOL`` by default); the output must be finite."""
    rtol, atol = tol[dt_name]
    g, w = got.double(), want.double()
    need(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
    need(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    diff = (g - w).abs()
    bad = diff > atol + rtol * w.abs()
    if bool(bad.any()):
        raise SmokeError(f"{name}: {int(bad.sum())} entries outside rtol={rtol} "
                         f"atol={atol}; max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def _row_rel(torch, name, got, want, limit=ATT_ROW_REL):
    """The worst relative L2 error over the output's rows (its last
    dimension), held to ``limit``. A row that is zeros in ``want`` must be
    zeros in ``got``."""
    g = got.double().reshape(-1, got.shape[-1])
    w = want.double().reshape(-1, want.shape[-1])
    err, norm = (g - w).norm(dim=1), w.norm(dim=1)
    zero = norm == 0
    need(not bool(err[zero].any()), f"{name}: a row that should be zeros is not")
    rel = float((err[~zero] / norm[~zero]).max()) if bool((~zero).any()) else 0.0
    need(rel <= limit, f"{name}: a row's relative L2 error {rel:.3e} exceeds {limit:.0e}")
    return rel


def _one_tile_fault(torch, q, k, v, want):
    """The relative L2 error of the rows of a causal attention that a kernel
    leaving out key tile FAULT_TILE (128 keys) would get wrong: the plain
    version's math with those keys masked for every later row, against
    ``want``. Returns (least, most) over those rows."""
    b, sq, h, hd = q.shape
    skv, rep = k.shape[1], h // k.shape[2]
    k0 = FAULT_TILE * 128
    r0 = k0 + 128
    kf = torch.repeat_interleave(k, rep, dim=2).float()
    vf = torch.repeat_interleave(v, rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:].float() * hd**-0.5, kf)
    rows = torch.arange(r0, sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    keep = (rows >= cols) & ((cols < k0) | (cols >= r0))
    p = torch.softmax(s.masked_fill(~keep, -1e30), dim=-1)
    fault = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype).double()
    w = want[:, r0:].double()
    rel = (fault - w).norm(dim=-1) / w.norm(dim=-1)
    return float(rel.min()), float(rel.max())


def _normal(torch, seed, shape, dtype):
    """Standard normal values made on the card from ``seed``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device="cuda").to(dtype)


DECODE_CASES = (   # label, B, Skv, H, KVH, hd, valid_len
    ("GQA rep 4 (the serve shape)", 8, 1088, 32, 8, 128, 1088),
    ("MQA", 2, 384, 8, 1, 64, 100),
    ("per-sequence lengths", 4, 256, 4, 2, 64, [1, 17, 128, 256]),
    ("valid_len 1", 3, 128, 4, 2, 32, 1),
    ("valid_len 0", 2, 64, 4, 2, 64, 0),
    ("per-sequence with zeros", 4, 300, 8, 2, 128, [0, 5, 0, 300]),
    ("Skv 1,000 off the split grid", 2, 1000, 16, 4, 128, 999),
)
ATTENTION_CASES = (   # label, B, Sq, Skv, H, KVH, hd, causal, window
    ("causal GQA", 1, 256, 256, 4, 2, 64, True, 0),
    ("non-causal", 1, 128, 128, 2, 2, 64, False, 0),
    ("window 48", 1, 200, 200, 4, 2, 128, True, 48),
    ("ragged Sq 130", 2, 130, 130, 4, 4, 128, True, 0),
    ("MQA, Sq 96 != Skv 160, non-causal", 1, 96, 160, 8, 1, 64, False, 0),
    ("the forward shape", 1, 4096, 4096, 32, 8, 128, True, 0),
)


def phase_attention_kernels(torch):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_reference

    errs = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        worst, parts, row_worst = 0.0, [], 0.0
        for i, (label, b, skv, h, kvh, hd, valid) in enumerate(DECODE_CASES):
            q = _normal(torch, 3 * i, (b, h, hd), dt)
            k = _normal(torch, 3 * i + 1, (b, skv, kvh, hd), dt)
            v = _normal(torch, 3 * i + 2, (b, skv, kvh, hd), dt)
            vl = (torch.tensor(valid, dtype=torch.int32, device="cuda")
                  if isinstance(valid, list) else valid)
            got = flash_decode(q, k, v, vl)
            want = flash_decode_reference(q, k, v, vl)
            torch.cuda.synchronize()
            e = _att_err(torch, f"flash_decode {dt_name} {label}", got, want, dt_name)
            if dt_name == "bfloat16":
                row_worst = max(row_worst, _row_rel(torch, f"flash_decode {label}", got, want))
            if isinstance(valid, list):
                for row, n in enumerate(valid):
                    need(n > 0 or not bool(got[row].float().abs().max()),
                         f"flash_decode {dt_name} {label}: row {row} with valid_len 0 "
                         "is not zeros")
            elif valid == 0:
                need(not bool(got.float().abs().max()),
                     f"flash_decode {dt_name}: valid_len 0 is not zeros")
            worst = max(worst, e)
            parts.append(f"{label} {e:.2e}")
        errs[("flash_decode", dt_name)] = worst
        rows = f"; worst row rel L2 {row_worst:.2e}" if dt_name == "bfloat16" else ""
        log(f"[3 kernels] flash_decode {dt_name}: max abs err vs plain " + "; ".join(parts)
            + rows)
        worst, parts, row_worst = 0.0, [], 0.0
        for i, (label, b, sq, skv, h, kvh, hd, causal, window) in enumerate(ATTENTION_CASES):
            q = _normal(torch, 50 + 3 * i, (b, sq, h, hd), dt)
            k = _normal(torch, 51 + 3 * i, (b, skv, kvh, hd), dt)
            v = _normal(torch, 52 + 3 * i, (b, skv, kvh, hd), dt)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_reference(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            e = _att_err(torch, f"flash_attention {dt_name} {label}", got, want, dt_name)
            worst = max(worst, e)
            parts.append(f"{label} {e:.2e}")
            if dt_name == "bfloat16":
                rel = _row_rel(torch, f"flash_attention {label}", got, want)
                row_worst = max(row_worst, rel)
                if sq == FORWARD_LEN:
                    fault = _one_tile_fault(torch, q, k, v, want)
                    need(fault[0] > ATT_ROW_REL,
                         f"flash_attention: a row missing key tile {FAULT_TILE} reads "
                         f"{fault[0]:.3e}, within the row limit {ATT_ROW_REL:.0e}")
                    log(f"[3 kernels] flash_attention bf16 forward shape: worst row rel L2 "
                        f"{rel:.3e} (kernel vs plain); rows missing key tile {FAULT_TILE} "
                        f"read {fault[0]:.3e}-{fault[1]:.3e}; limit {ATT_ROW_REL:.0e}")
            del q, k, v, got, want
        errs[("flash_attention", dt_name)] = worst
        rows = f"; worst row rel L2 {row_worst:.2e}" if dt_name == "bfloat16" else ""
        log(f"[3 kernels] flash_attention {dt_name}: max abs err vs plain " + "; ".join(parts)
            + rows)
        errs.update(_attention_sweeps(torch, dt_name))
    torch.cuda.empty_cache()
    return errs


# Boundary sweeps. flash_attention: Sq = Skv on both sides of the 16-row
# fragments of a warp, the 64-row tiles (a bf16 warpgroup's, the float32
# blocks'), the 64/128-key tiles and the 128-row bf16 blocks, under
# each mask, at both head dims and three GQA ratios (H = 4), and one
# Sq != Skv case. flash_decode: valid_len across the split (128
# positions) and cluster (8 splits) boundaries, as an int and as a
# per-sequence tensor with zeros among the lengths, at every head dim.
SWEEP_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000)
SWEEP_MASKS = ((True, 0), (False, 0), (True, 48))   # causal, non-causal, window 48
SWEEP_DECODE_SKV = 1536
SWEEP_VALID = (0, 1, 127, 128, 129, 1023, 1088, SWEEP_DECODE_SKV)


def _attention_sweeps(torch, dt_name):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_reference

    dt = getattr(torch, dt_name)
    worst, n, row_worst = 0.0, 0, 0.0
    shapes = [(1, s, s, 4, kvh, hd, causal, window) for s in SWEEP_LENGTHS
              for causal, window in SWEEP_MASKS for hd in (64, 128) for kvh in (1, 2, 4)]
    shapes += [(2, 129, 1000, 8, 2, 128, causal, window) for causal, window in SWEEP_MASKS]
    for i, (b, sq, skv, h, kvh, hd, causal, window) in enumerate(shapes):
        q = _normal(torch, 200 + 3 * i, (b, sq, h, hd), dt)
        k = _normal(torch, 201 + 3 * i, (b, skv, kvh, hd), dt)
        v = _normal(torch, 202 + 3 * i, (b, skv, kvh, hd), dt)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_reference(q, k, v, causal=causal, window=window)
        name = (f"flash_attention {dt_name} sweep B={b} Sq={sq} Skv={skv} H={h} KVH={kvh} "
                f"hd={hd} causal={causal} window={window}")
        worst = max(worst, _att_err(torch, name, got, want, dt_name))
        if dt_name == "bfloat16":
            row_worst = max(row_worst, _row_rel(torch, name, got, want))
        n += 1
    rows = f", worst row rel L2 {row_worst:.2e}" if dt_name == "bfloat16" else ""
    log(f"[3 kernels] flash_attention {dt_name} boundary sweep: {n} cases (Sq = Skv in "
        f"{SWEEP_LENGTHS} x 3 masks x hd 64/128 x KVH 1/2/4, and Sq 129 != Skv 1000), "
        f"max abs err vs plain {worst:.2e}" + rows)
    out = {("flash_attention sweep", dt_name): worst}
    worst, n, row_worst = 0.0, 0, 0.0
    b, h, kvh = len(SWEEP_VALID), 8, 2
    for hd in (32, 64, 128):
        q = _normal(torch, 300 + hd, (b, h, hd), dt)
        k = _normal(torch, 301 + hd, (b, SWEEP_DECODE_SKV, kvh, hd), dt)
        v = _normal(torch, 302 + hd, (b, SWEEP_DECODE_SKV, kvh, hd), dt)
        lens = torch.tensor(SWEEP_VALID, dtype=torch.int32, device="cuda")
        for valid in (*SWEEP_VALID, lens):
            got = flash_decode(q, k, v, valid)
            want = flash_decode_reference(q, k, v, valid)
            label = "per-sequence" if isinstance(valid, torch.Tensor) else valid
            name = f"flash_decode {dt_name} sweep hd={hd} valid_len={label}"
            worst = max(worst, _att_err(torch, name, got, want, dt_name))
            if dt_name == "bfloat16":
                row_worst = max(row_worst, _row_rel(torch, name, got, want))
            zero = got[lens == 0] if isinstance(valid, torch.Tensor) else got[:b * (valid == 0)]
            need(bool((zero == 0).all()),
                 f"flash_decode {dt_name} sweep hd={hd}: a row with valid_len 0 is not zeros")
            n += 1
    rows = f", worst row rel L2 {row_worst:.2e}" if dt_name == "bfloat16" else ""
    log(f"[3 kernels] flash_decode {dt_name} valid_len sweep: {n} calls (valid_len in "
        f"{SWEEP_VALID} as ints and as one per-sequence tensor, Skv {SWEEP_DECODE_SKV}, "
        f"hd 32/64/128), max abs err vs plain {worst:.2e}" + rows)
    out[("flash_decode sweep", dt_name)] = worst
    return out


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
            cluster=ClusterSpec(n_nodes=-(-pp * dp * tp // 8)),
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


def _packed_cells(torch, np, arrays, shape):
    """The five float64 cell arrays in one packed buffer on the card."""
    from repro_torch.kernels.cell_reduce import pack_cells, packed_layout

    buf = np.zeros(packed_layout(*shape)[1])
    pack_cells(buf, arrays, shape)
    return torch.as_tensor(buf).to("cuda")


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


# ------------------------------------------------------- phases 6 and 7
def _zero_launches():
    from repro_torch.kernels.bocd_step import bocd_step
    from repro_torch.kernels.cell_reduce import cell_reduce
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan

    wrappers = {"bocd_step": bocd_step, "cell_reduce": cell_reduce,
                "flash_decode": flash_decode, "flash_attention": flash_attention,
                "ssd_scan": ssd_scan}
    for w in wrappers.values():
        w.launches = 0
    return lambda: {n: w.launches for n, w in wrappers.items()}


def _falcon_reference(cfg, total=SERVE_PROMPT + SERVE_GEN, gen=SERVE_GEN,
                      inject=SERVE_INJECT):
    """The serve driver's latency loop on the CPU without the model: the
    port's simulator, injector and detector, as ``serve`` runs them."""
    from repro_torch.cluster.injector import FailSlowInjector
    from repro_torch.core.detector import FalconDetect
    from repro_torch.launch.serve import VERIFY_WINDOW, parse_injection, serve_simulator

    sim = serve_simulator(cfg, total, device="cpu")
    injector = FailSlowInjector([parse_injection(inject)])
    detector = FalconDetect(cluster=sim, verify_window=VERIFY_WINDOW)
    wall, events = 0.0, []
    for step in range(gen):
        injector.apply(sim.state, wall)
        latency = sim.iteration_time()
        wall += latency
        ev = detector.observe(latency, wall)
        if ev is not None:
            events.append((step, ev.root_cause.value, list(ev.components),
                           ev.t_healthy, ev.t_slow))
    return events


def _logit_diff(torch, got, want, vocab):
    """(max abs difference, entries outside PARITY_TOL, relative L2
    difference, argmax agreement) of two logit tensors (..., Vp), over the
    ``vocab`` real columns (the padding holds -1e9 in both)."""
    got, want = got[..., :vocab], want[..., :vocab]
    g, w = got.double(), want.double()
    need(bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all()),
         "non-finite logits")
    diff = (g - w).abs()
    rtol, atol = PARITY_TOL
    bad = int((diff > atol + rtol * w.abs()).sum())
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    agree = float((got.argmax(-1) == want.argmax(-1)).double().mean())
    return float(diff.max()), bad, rel, agree


def _teacher_forced(torch, cfg, params, prompt):
    """Decode TEACHER_STEPS tokens with the kernel route; before each step
    the plain route runs on a copy of the same caches with the same token
    (the plain route's token is fed to both). Returns the per-step
    ``_logit_diff`` results."""
    from repro_torch.models import transformer
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    total = SERVE_PROMPT + TEACHER_STEPS
    out = []
    with torch.no_grad():
        logits, caches = make_prefill_step(cfg, SERVE_PROMPT)(params, {"tokens": prompt})
        caches = transformer.grow_caches(caches, cfg, total)
        kern = make_decode_step(cfg, total, use_kernel=True)
        plain = make_decode_step(cfg, total, use_kernel=False)
        tok = torch.argmax(logits[:, -1], dim=-1).reshape(SERVE_B, 1)
        for step in range(TEACHER_STEPS):
            copy = {s: {k: t.clone() for k, t in c.items()} for s, c in caches.items()}
            want, _ = plain(params, tok, copy, SERVE_PROMPT + step)
            del copy
            got, caches = kern(params, tok, caches, SERVE_PROMPT + step)
            out.append(_logit_diff(torch, got, want, cfg.vocab_size))
            tok = torch.argmax(want[:, -1], dim=-1).reshape(SERVE_B, 1)
    return out


def _summary(diffs):
    worst = max(d[0] for d in diffs)
    bad = sum(d[1] for d in diffs)
    rel = max(d[2] for d in diffs)
    agree = sum(d[3] for d in diffs) / len(diffs)
    return worst, bad, rel, agree


def phase_serve(torch, np, card):
    """Slice 2's main path: the port's serve driver at the published width
    of granite-3-8b with the kernel route. Launch counts are zeroed just
    before and read just after."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as model_lib

    cfg = get_config(SERVE_ARCH)   # --no-smoke: the published width
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)),
                             device="cuda")
    ref_events = _falcon_reference(cfg)
    need([e[:3] for e in ref_events] == [SERVE_EVENT],
         f"the CPU latency loop flags {[e[:3] for e in ref_events]}, expected "
         f"{[SERVE_EVENT]}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _zero_launches()
    res = serve(cfg, params, prompt, gen=SERVE_GEN, use_kernel=True,
                inject=[SERVE_INJECT], device="cuda")
    torch.cuda.synchronize()
    launches = read()
    peak = torch.cuda.max_memory_allocated()

    need(launches["flash_decode"] == cfg.num_layers * SERVE_GEN,
         f"flash_decode launched {launches['flash_decode']} times, expected "
         f"{cfg.num_layers} x {SERVE_GEN}")
    need(bool(torch.isfinite(res.logits.float()).all()), "serve: non-finite logits")
    need(bool(torch.isfinite(res.prefill_logits.float()).all()),
         "serve: non-finite prefill logits")
    need(res.tokens.shape == (SERVE_B, SERVE_GEN), f"serve: tokens {res.tokens.shape}")
    need(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size,
         "serve: a token in the padded vocab")
    got = [(step, ev.root_cause.value, list(ev.components), ev.t_healthy, ev.t_slow)
           for step, ev in res.events]
    need(got == ref_events, f"serve flags {got}, the CPU loop {ref_events}")
    decode_s = sum(res.step_s)
    log(f"[6 serve] {cfg.name} published width ({n_params / 1e9:.3f} B parameters, "
        f"bf16, init {init_s:.2f} s), {SERVE_B} requests x ({SERVE_PROMPT} prompt + "
        f"{SERVE_GEN} generated), use_kernel, inject {SERVE_INJECT}; card: {card}")
    log(f"[6 serve] launches {launches}; FALCON flags {got[0][1]} on {got[0][2]} at "
        f"token {got[0][0]} ({got[0][3]:.4f} s -> {got[0][4]:.4f} s), the same as "
        f"the CPU latency loop; logits finite")
    log(f"[6 serve] prefill {res.prefill_s:.4f} s (host clock, synchronised); decode "
        f"{SERVE_B * SERVE_GEN / decode_s:.1f} tokens/s on the host clock "
        f"({decode_s / SERVE_GEN * 1e3:.3f} ms per step, median "
        f"{statistics.median(res.step_s) * 1e3:.3f} ms); peak memory "
        f"{peak / 2**30:.2f} GiB; card: {card}")
    return cfg, params, prompt, launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_forward(torch, np, card, cfg, params):
    """``model.forward(use_kernel=True)`` over FORWARD_LEN tokens in bf16;
    launches zeroed just before the kernel route and read just after. The
    plain route's logits are reported beside it (held to a tolerance in
    float32, phase 9). Returns the launches and the tokens."""
    from repro_torch.models import model as model_lib

    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, FORWARD_LEN)),
                             device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        read = _zero_launches()
        t0 = time.perf_counter()
        got, _ = model_lib.forward(params, {"tokens": tokens}, cfg, use_kernel=True)
        torch.cuda.synchronize()
        kern_s = time.perf_counter() - t0
        launches = read()
        t0 = time.perf_counter()
        want, _ = model_lib.forward(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    worst, _, rel, agree = _logit_diff(torch, got, want, cfg.vocab_size)
    log(f"[7 forward] {cfg.name} bf16 forward over (1, {FORWARD_LEN}) tokens, "
        f"use_kernel: launches {launches}; vs the plain blocked attention: max abs "
        f"logit diff {worst:.3e}, relative L2 {rel:.3e}, argmax agrees on "
        f"{agree:.4%} of positions; {kern_s:.3f} s kernel route, {plain_s:.3f} s "
        f"plain route (host clock); card: {card}")
    need(launches["flash_attention"] == cfg.num_layers,
         f"flash_attention launched {launches['flash_attention']} times, expected "
         f"{cfg.num_layers}")
    return launches, tokens


def phase_parity(torch, card, cfg, params, prompt, tokens):
    """Kernel route vs plain route at the published width: teacher-forced
    decode on the same caches and the 4,096-token forward. bf16 reported;
    float32 (weights upcast exactly) held to PARITY_TOL."""
    from dataclasses import replace

    from repro_torch.models import model as model_lib

    diffs = _teacher_forced(torch, cfg, params, prompt)
    worst, bad, rel, agree = _summary(diffs)
    log(f"[9 parity] bf16 teacher-forced decode, kernel vs plain route on the same "
        f"caches, {TEACHER_STEPS} steps: max abs logit diff {worst:.3e}, relative L2 "
        f"{rel:.3e}, argmax agrees {agree:.4%}")
    cfg32 = replace(cfg, dtype="float32")
    params32 = _as_float(torch, params)
    torch.cuda.empty_cache()
    diffs = _teacher_forced(torch, cfg32, params32, prompt)
    worst, bad, rel, agree = _summary(diffs)
    log(f"[9 parity] float32 teacher-forced decode, kernel vs plain route on the "
        f"same caches, {TEACHER_STEPS} steps: max abs logit diff {worst:.3e}, "
        f"{bad} entries outside rtol/atol {PARITY_TOL[0]}/{PARITY_TOL[1]}, relative "
        f"L2 {rel:.3e}, argmax agrees {agree:.4%}")
    fwd_bad = 0
    with torch.no_grad():
        got, _ = model_lib.forward(params32, {"tokens": tokens}, cfg32, use_kernel=True)
        want, _ = model_lib.forward(params32, {"tokens": tokens}, cfg32)
        f_worst, fwd_bad, f_rel, f_agree = _logit_diff(torch, got, want, cfg.vocab_size)
        del got, want
    log(f"[9 parity] float32 forward over (1, {FORWARD_LEN}), kernel vs plain route: "
        f"max abs logit diff {f_worst:.3e}, {fwd_bad} entries outside rtol/atol "
        f"{PARITY_TOL[0]}/{PARITY_TOL[1]}, relative L2 {f_rel:.3e}, argmax agrees "
        f"{f_agree:.4%}; card: {card}")
    del params32
    torch.cuda.empty_cache()
    need(bad == 0, f"float32 teacher-forced decode: {bad} logits outside tolerance")
    need(fwd_bad == 0, f"float32 forward: {fwd_bad} logits outside tolerance")


def _as_float(torch, tree):
    return {k: _as_float(torch, v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


# ------------------------------------------------------------------ phase 8
def _device_ms(torch, fn, runs=100, chunk=10, warmup=5):
    """Median device time of ``fn()`` over ``runs`` calls. Each chunk of
    calls is queued behind a sleeping kernel long enough to cover the host's
    enqueue time, so each event pair brackets device work only."""
    for _ in range(warmup):
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
    split = _kernel_split(torch, lambda: bocd_step(*args))
    bocd_step.launches = saved
    nbytes = 4 * (6 * k * b + 3 * b + 6 * k)   # state, x, mu0, p0, (K,1) vectors
    flops = 45 * k * b                          # ~45 operations per (slot, stream)
    out.append(_row("bocd_step", "src/repro_torch/kernels/csrc/bocd_step.cu",
                    "src/repro/kernels/bocd_step.py:179", launches["bocd_step"],
                    errs[("bocd_step", "float32", 16384, k)], ms, plain_ms, nbytes, flops))
    log(f"[8 times] bocd_step f32 K={k} B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(device, median of >=100); per call with host {call_ms:.4f} / "
        f"{plain_call_ms:.4f} ms; bound {out[-1]['bound_ms']:.4f} ms ({out[-1]['bound_by']}); "
        f"CUDA kernels per call: {split}; limit {BOCD_GATE_MS} ms; card: {card}")
    need(ms <= BOCD_GATE_MS, f"bocd_step f32 K={k} B={b} takes {ms:.4f} ms, above "
         f"{BOCD_GATE_MS} ms")
    # The pipeline's screen is one stream wide: the same step at B = 1.
    x1 = _bocd_inputs(np, 1, 2)
    state1, mu01 = _bocd_init(torch, np, x1[0], k, torch.float32, dev)
    args1 = (torch.as_tensor(x1[1]).to(dev, torch.float32), *state1, mu01,
             0.01, 1.0, 1.0, 1.0, 1e-6)
    saved = bocd_step.launches
    ms1, call1 = _device_ms(torch, lambda: bocd_step(*args1))
    plain1, plain_call1 = _device_ms(torch, lambda: bocd_step_reference(*args1))
    bocd_step.launches = saved
    log(f"[8 times] bocd_step f32 K={k} B=1 (the pipeline's screen): kernel {ms1:.4f} ms, "
        f"plain {plain1:.4f} ms (device, median of >=100); per call with host "
        f"{call1:.4f} / {plain_call1:.4f} ms; card: {card}")
    # FleetDetect's adaptive cap at its upper bound: K = 256, above the 128
    # slots whose rows stay in registers (reported).
    for xs in (x, x1):
        state256, mu0256 = _bocd_init(torch, np, xs[0], 256, torch.float32, dev)
        args256 = (torch.as_tensor(xs[1]).to(dev, torch.float32), *state256, mu0256,
                   0.01, 1.0, 1.0, 1.0, 1e-6)
        saved = bocd_step.launches
        ms256, call256 = _device_ms(torch, lambda: bocd_step(*args256))
        plain256, _ = _device_ms(torch, lambda: bocd_step_reference(*args256))
        bocd_step.launches = saved
        log(f"[8 times] bocd_step f32 K=256 B={xs.shape[1]}: kernel {ms256:.4f} ms, plain "
            f"{plain256:.4f} ms (device, median of >=100); per call with host "
            f"{call256:.4f} ms; card: {card}")
    out += _times_cell_reduce(torch, np, card, errs, launches)
    return out


def _times_cell_reduce(torch, np, card, errs, launches):
    """cell_reduce's device times (float32 arithmetic on the packed float64
    cells) at the 10,240-device job and at (16, 128, 8), beside the empty
    launch and the bound; then one evaluation with the host included, the
    packed route against the unpacked one in turns. Holds CELL_GATE_MS and
    EVAL_RATIO."""
    from repro_torch.cluster.simulator import CudaReduction
    from repro_torch.kernels.cell_reduce import (
        blocks_of, cell_reduce, cell_reduce_packed, cell_reduce_packed_reference, empty_launch,
        out_size)

    dev = torch.device("cuda")
    saved = cell_reduce.launches
    floor_ms, _ = _device_ms(torch, lambda: empty_launch(dev))
    rows = {}
    for shape in ((8, 160, 8), (16, 128, 8)):
        arrays, consts, _ = _cells_of(np, shape)
        cells = _packed_cells(torch, np, arrays, shape)
        res = torch.empty(out_size(*shape), dtype=torch.float32, device=dev)
        ins = [torch.as_tensor(a).to(dev, torch.float32) for a in arrays]
        ms, call_ms = _device_ms(torch, lambda: cell_reduce_packed(cells, shape, *consts, out=res))
        plain_ms, _ = _device_ms(
            torch, lambda: cell_reduce_packed_reference(cells, shape, *consts, out=res))
        f32_ms, _ = _device_ms(torch, lambda: cell_reduce(*ins, *consts))
        pp, dp, tp = shape
        n_in = pp * dp + 2 * pp * dp * tp + (pp - 1) * dp + dp
        n_out = out_size(*shape)
        nbytes = 8 * n_in + 4 * n_out      # float64 cells in, float32 results out
        flops = 2 * pp * dp * tp + 4 * pp * dp + 2 * (pp - 1) * dp + 3 * dp
        row = _row("cell_reduce", "src/repro_torch/kernels/csrc/cell_reduce.cu",
                   "src/repro/kernels/cell_reduce.py:87", launches["cell_reduce"],
                   errs[("cell_reduce", "float32", shape)], ms, plain_ms, nbytes, flops)
        rows[shape] = row
        log(f"[8 times] cell_reduce f32 on packed f64 cells pp,dp,tp={shape} "
            f"({nbytes} B; (blocks, dp columns a block) = {blocks_of(dp)}): kernel {ms:.4f} "
            f"ms (earlier design {CELL_EARLIER_MS} ms at (8,160,8)); "
            f"on float32 copies {f32_ms:.4f} ms; plain {plain_ms:.4f} ms (device, median of "
            f">=100); per call with host {call_ms:.4f} ms; empty launch of one "
            f"512-thread block {floor_ms:.4f} ms; bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}); limit {CELL_GATE_MS} ms at (8,160,8); card: {card}")
    ms = rows[(8, 160, 8)]["ms"]
    need(ms <= CELL_GATE_MS, f"cell_reduce f32 (8,160,8) takes {ms:.4f} ms, above "
         f"{CELL_GATE_MS} ms")

    # One evaluation on a new memo key, host included: the packed route
    # (CudaReduction) against five float32 copies, the kernel, cat, .cpu().
    arrays, consts, _ = _cells_of(np, (8, 160, 8))
    rb = CudaReduction(dev)

    def packed():
        return rb.evaluate(arrays, consts, (8, 160, 8))

    def unpacked():
        ins = [torch.as_tensor(a).to(dev, torch.float32) for a in arrays]
        res = cell_reduce(*ins, *consts)
        return torch.cat([r.reshape(-1) for r in res]).to(torch.float64).cpu().numpy()

    need(bool(np.array_equal(packed(), unpacked())),
         "cell_reduce: the packed evaluation differs from the unpacked float32 route")
    times = {packed: [], unpacked: []}
    for _ in range(5):
        packed(), unpacked()
    for i in range(EVAL_RUNS):
        for fn in ((packed, unpacked) if i % 2 == 0 else (unpacked, packed)):
            t0 = time.perf_counter()
            fn()
            times[fn].append((time.perf_counter() - t0) * 1e3)
    cell_reduce.launches = saved
    p_ms, u_ms = statistics.median(times[packed]), statistics.median(times[unpacked])
    log(f"[8 times] cell_reduce evaluation at 10,240 devices, host included (median of "
        f"{EVAL_RUNS} each, in turns): packed {p_ms:.4f} ms (one upload of "
        f"{rb.copy_bytes // rb.copies} B, one launch, one download, one sync), unpacked "
        f"{u_ms:.4f} ms (five float32 copies, kernel, cat, .cpu()); ratio {p_ms / u_ms:.3f}, "
        f"limit {EVAL_RATIO}; bit-equal results; card: {card}")
    need(p_ms <= EVAL_RATIO * u_ms, f"the packed evaluation ({p_ms:.4f} ms) is not at most "
         f"{EVAL_RATIO} x the unpacked one ({u_ms:.4f} ms)")
    return [rows[(8, 160, 8)]]


def _row(name, source, replaces, launches, err, ms, plain_ms, nbytes, flops,
         flop_rate=FP32_FLOP_PER_S, library_ms=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def _library_ms(torch, fn, label):
    """Median device ms of one PyTorch call computing the same function
    (timed here only; the port never calls it), or None where this torch
    cannot run it."""
    try:
        fn()
        torch.cuda.synchronize()
    except (TypeError, RuntimeError) as exc:
        log(f"[8 times] {label}: no library time ({type(exc).__name__}: {exc})")
        return None
    return _device_ms(torch, fn)[0]


def _ratios(row, lib_ms):
    """'x.xx x sdpa, y.y x bound' for a kernel row."""
    lib = "no sdpa" if lib_ms is None else f"{row['ms'] / lib_ms:.2f} x sdpa"
    return f"{lib}, {row['ms'] / row['bound_ms']:.2f} x its bound"


def phase_times_attention(torch, card, errs, serve_launches, forward_launches):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_reference

    out = []
    saved = (flash_decode.launches, flash_attention.launches)
    bf = torch.bfloat16
    # flash_decode at the serve's last step: B = 8, 1,088 valid of 1,088.
    b, h, kvh, hd = SERVE_B, 32, 8, 128
    for skv in (SERVE_PROMPT + SERVE_GEN, 32768):
        q = _normal(torch, 90, (b, h, hd), bf)
        k = _normal(torch, 91, (b, skv, kvh, hd), bf)
        v = _normal(torch, 92, (b, skv, kvh, hd), bf)
        valid = skv
        ms, call_ms = _device_ms(torch, lambda: flash_decode(q, k, v, valid))
        plain_ms, _ = _device_ms(torch, lambda: flash_decode_reference(q, k, v, valid))
        kt, vt = k[:, :valid].transpose(1, 2), v[:, :valid].transpose(1, 2)
        lib_ms = _library_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, enable_gqa=True), "flash_decode sdpa")
        nbytes = 2 * b * valid * kvh * hd * 2 + 2 * b * h * hd * 2
        flops = 4 * b * h * valid * hd
        row = _row("flash_decode", "src/repro_torch/kernels/csrc/flash_decode.cu",
                   "src/repro/kernels/flash_decode.py:74", serve_launches["flash_decode"],
                   errs[("flash_decode", "bfloat16")], ms, plain_ms, nbytes, flops,
                   BF16_FLOP_PER_S, lib_ms)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[8 times] flash_decode bf16 B={b} H={h} KVH={kvh} hd={hd} valid={valid}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib} (device, median "
            f"of >=100); per call with host {call_ms:.4f} ms; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes / 1e6:.2f} MB); "
            f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; {_ratios(row, lib_ms)}; card: {card}")
        if skv == SERVE_PROMPT + SERVE_GEN:
            out.append(row)
        del q, k, v, kt, vt
    # flash_attention at the forward's shape.
    b, s, h, kvh, hd = 1, FORWARD_LEN, 32, 8, 128
    q = _normal(torch, 93, (b, s, h, hd), bf)
    k = _normal(torch, 94, (b, s, kvh, hd), bf)
    v = _normal(torch, 95, (b, s, kvh, hd), bf)
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
    flops = 4 * b * h * hd * (s * (s + 1) // 2)
    ms, call_ms = _device_ms(torch, lambda: flash_attention(q, k, v, causal=True), runs=30)
    plain_ms, _ = _device_ms(torch, lambda: flash_attention_reference(q, k, v, causal=True),
                             runs=30)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = _library_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), "flash_attention sdpa")
    row = _row("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:91", forward_launches["flash_attention"],
               errs[("flash_attention", "bfloat16")], ms, plain_ms, nbytes, flops,
               BF16_FLOP_PER_S, lib_ms)
    out.append(row)
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"[8 times] flash_attention bf16 causal B={b} S={s} H={h} KVH={kvh} hd={hd}: kernel "
        f"{ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s; {_ratios(row, lib_ms)}), "
        f"plain {plain_ms:.4f} ms, sdpa {lib} (device, median of >=30); per call with host "
        f"{call_ms:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{flops / 1e9:.1f} GFLOP); card: {card}")
    flash_decode.launches, flash_attention.launches = saved
    return out


# ------------------------------------------------------- phases 10 to 13
SSD_CASES = (   # label, B, S, H, P, G, N, chunk, dt scale
    ("16-step chunks, N 16", 1, 64, 2, 32, 1, 16, 16, 0.5),
    ("two groups", 2, 128, 4, 64, 2, 32, 32, 0.5),
    ("three chunks, P 16", 1, 96, 2, 16, 1, 8, 32, 0.5),
    ("the forward shape", 1, FORWARD_LEN, 80, 64, 1, 128, 128, 0.5),
    ("long memory, the forward shape", 1, FORWARD_LEN, 80, 64, 1, 128, 128, 0.005),
)
# The reference's dt (softplus(normal) / 2, a ~ -1) decays the state by
# ~e^-51 a 128-step chunk, so those inputs cannot tell the recurrence across
# chunks from a kernel that drops it; dt 100x smaller decays by ~e^-0.5 a
# chunk and carries the state through all 32 chunks.
# bf16 y is also held row by row (the P values of one (b, t, h)) to a
# relative L2 error. Sound rows read a few 1e-3 (y rounded to bf16); a
# plain version that drops the state entering chunk FAULT_CHUNK reads far
# above the limit on the long-memory inputs (phase 3 prints both).
SSD_ROW_REL = 2e-2
FAULT_CHUNK = 16
# Limits on the card, both held on device time: bf16 ssd_scan at the
# forward shape at most 0.5 ms (and faster than the plain chunked route);
# bocd_step at K 32, B 16,384 float32 at most 0.025 ms.
SSD_GATE_MS = 0.5
BOCD_GATE_MS = 0.025


def _ssd_inputs(torch, seed, shape, dtype, dt_scale=0.5):
    """x, dt, a, B, C as the reference's kernel tests make them: dt =
    softplus(normal) * dt_scale (their 0.5 by default) and a =
    -exp(normal / 5) in float32, the rest in ``dtype``."""
    b, s, h, p, g, n = shape
    x = _normal(torch, seed, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(_normal(torch, seed + 1, (b, s, h), torch.float32))
    dt = dt * dt_scale
    a = -torch.exp(_normal(torch, seed + 2, (h,), torch.float32) * 0.2)
    bm = _normal(torch, seed + 3, (b, s, g, n), dtype)
    cm = _normal(torch, seed + 4, (b, s, g, n), dtype)
    return x, dt, a, bm, cm


def _dropped_handoff(torch, ins, chunk, want):
    """The relative L2 error of the rows of chunk FAULT_CHUNK that a scan
    dropping the state entering that chunk would give (the plain chunked
    route in float32 from that chunk on, from no initial state), against
    ``want``. Returns (least, most) over those rows."""
    from repro_torch.models.ssm import ssd_scan as chunked

    x, dt, a, bm, cm = (t.float() for t in ins)
    cut = FAULT_CHUNK * chunk
    tail = [t[:, cut:] if t.dim() > 1 else t for t in (x, dt, a, bm, cm)]
    y_tail, _ = chunked(*tail, chunk)   # the handoff into chunk FAULT_CHUNK dropped
    fault = y_tail[:, :chunk].to(want.dtype).double()
    w = want[:, cut:cut + chunk].double()
    rel = (fault - w).norm(dim=-1) / w.norm(dim=-1)
    return float(rel.min()), float(rel.max())


def phase_ssd_kernel(torch):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_reference

    errs = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        worst, parts, row_worst = 0.0, [], 0.0
        for i, (label, b, s, h, p, g, n, chunk, scale) in enumerate(SSD_CASES):
            ins = _ssd_inputs(torch, 70 + 5 * i, (b, s, h, p, g, n), dt, scale)
            y, st = ssd_scan(*ins, chunk=chunk)
            y_r, st_r = ssd_scan_reference(*ins)
            torch.cuda.synchronize()
            e = max(_att_err(torch, f"ssd_scan {dt_name} {label} y", y, y_r, dt_name, SSD_TOL),
                    _att_err(torch, f"ssd_scan {dt_name} {label} final state", st, st_r,
                             dt_name, SSD_TOL))
            worst = max(worst, e)
            parts.append(f"{label} {e:.2e}")
            if dt_name == "bfloat16":
                rel = _row_rel(torch, f"ssd_scan {label}", y, y_r, SSD_ROW_REL)
                row_worst = max(row_worst, rel)
                if s == FORWARD_LEN and scale < 0.5:
                    fault = _dropped_handoff(torch, ins, chunk, y_r)
                    need(fault[0] > SSD_ROW_REL,
                         f"ssd_scan: a row of chunk {FAULT_CHUNK} without the state entering "
                         f"it reads {fault[0]:.3e}, within the row limit {SSD_ROW_REL:.0e}")
                    log(f"[3 kernels] ssd_scan bf16 {label}: worst row rel L2 {rel:.3e} "
                        f"(kernel vs plain); rows of chunk {FAULT_CHUNK} without the state "
                        f"entering it read {fault[0]:.3e}-{fault[1]:.3e}; limit "
                        f"{SSD_ROW_REL:.0e}")
            del ins, y, st, y_r, st_r
        errs[("ssd_scan", dt_name)] = worst
        rows = f"; worst row rel L2 {row_worst:.2e}" if dt_name == "bfloat16" else ""
        log(f"[3 kernels] ssd_scan {dt_name}: max abs err vs plain (y and final state) "
            + "; ".join(parts) + rows)
    torch.cuda.empty_cache()
    return errs


def phase_mamba_forward(torch, np, card):
    """Slice 3's forward path: ``model.forward(use_kernel=True)`` of
    mamba2-2.7b at its published width over FORWARD_LEN tokens; launches
    zeroed just before the kernel route and read just after. The plain
    chunked route is compared in bf16 (reported) and float32 (held to
    PARITY_TOL). Returns the config, the bf16 and float32 weights and the
    launches."""
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config(MAMBA_ARCH)   # the published width
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, FORWARD_LEN)),
                             device="cuda")
    def timed(use_kernel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = model_lib.forward(params, {"tokens": tokens}, cfg, use_kernel=use_kernel)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        read = _zero_launches()
        got, kern_s = timed(True)
        launches = read()
        want, plain_s = timed(False)
        # Each route's time is the median of three forwards, taken in turns.
        kern_t, plain_t = [kern_s], [plain_s]
        for _ in range(2):
            kern_t.append(timed(True)[1])
            plain_t.append(timed(False)[1])
        kern_s, plain_s = statistics.median(kern_t), statistics.median(plain_t)
    need(launches["ssd_scan"] == cfg.num_layers,
         f"ssd_scan launched {launches['ssd_scan']} times, expected {cfg.num_layers}")
    need(kern_s < plain_s, f"the kernel route ({kern_s:.3f} s) is not faster than the plain "
         f"chunked route ({plain_s:.3f} s)")
    worst, _, rel, agree = _logit_diff(torch, got, want, cfg.vocab_size)
    del got, want
    log(f"[10 mamba forward] {cfg.name} published width ({n_params / 1e9:.3f} B "
        f"parameters, bf16, init {init_s:.2f} s), forward over (1, {FORWARD_LEN}) tokens, "
        f"use_kernel: launches {launches}; vs the plain chunked SSD in bf16: max abs logit "
        f"diff {worst:.3e}, relative L2 {rel:.3e}, argmax agrees {agree:.4%}; {kern_s:.3f} s "
        f"kernel route, {plain_s:.3f} s plain route (host clock, median of 3); card: {card}")
    cfg32 = replace(cfg, dtype="float32")
    params32 = _as_float(torch, params)
    with torch.no_grad():
        got, _ = model_lib.forward(params32, {"tokens": tokens}, cfg32, use_kernel=True)
        want, _ = model_lib.forward(params32, {"tokens": tokens}, cfg32)
        f_worst, bad, f_rel, f_agree = _logit_diff(torch, got, want, cfg.vocab_size)
        del got, want
    log(f"[10 mamba forward] float32 (weights upcast exactly), kernel vs plain chunked "
        f"route: max abs logit diff {f_worst:.3e}, {bad} entries outside rtol/atol "
        f"{PARITY_TOL[0]}/{PARITY_TOL[1]}, relative L2 {f_rel:.3e}, argmax agrees "
        f"{f_agree:.4%}; card: {card}")
    need(bad == 0, f"mamba float32 forward: {bad} logits outside tolerance")
    torch.cuda.empty_cache()
    return cfg, params, params32, launches


def phase_mamba_serve(torch, np, card, cfg, params, params32):
    """mamba2-2.7b through the serve driver (prefill by the plain chunked
    SSD, decode by the recurrence, as in the reference): the FALCON onset
    of the CPU latency loop; then, in float32, teacher-forced decode logits
    of the generated tokens against the kernel forward's at the same
    positions of the same sequence."""
    from dataclasses import replace

    from repro_torch.launch.serve import serve
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    total = MAMBA_PROMPT + MAMBA_GEN
    ref_events = _falcon_reference(cfg, total, MAMBA_GEN, MAMBA_INJECT)
    need([e[:3] for e in ref_events] == [MAMBA_EVENT],
         f"the CPU latency loop flags {[e[:3] for e in ref_events]}, expected "
         f"{[MAMBA_EVENT]}")
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (MAMBA_B, MAMBA_PROMPT)),
                             device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _zero_launches()
    res = serve(cfg, params, prompt, gen=MAMBA_GEN, use_kernel=True,
                inject=[MAMBA_INJECT], device="cuda")
    torch.cuda.synchronize()
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    need(bool(torch.isfinite(res.logits.float()).all()), "mamba serve: non-finite logits")
    need(res.tokens.shape == (MAMBA_B, MAMBA_GEN), f"mamba serve: tokens {res.tokens.shape}")
    need(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size,
         "mamba serve: a token in the padded vocab")
    got = [(step, ev.root_cause.value, list(ev.components), ev.t_healthy, ev.t_slow)
           for step, ev in res.events]
    need(got == ref_events, f"mamba serve flags {got}, the CPU loop {ref_events}")
    decode_s = sum(res.step_s)
    log(f"[11 mamba serve] {cfg.name} published width, {MAMBA_B} requests x "
        f"({MAMBA_PROMPT} prompt + {MAMBA_GEN} generated), inject {MAMBA_INJECT}: launches "
        f"{launches}; FALCON flags {got[0][1]} on {got[0][2]} at token {got[0][0]} "
        f"({got[0][3]:.4f} s -> {got[0][4]:.4f} s), the same as the CPU latency loop; "
        f"prefill {res.prefill_s:.4f} s; decode {MAMBA_B * MAMBA_GEN / decode_s:.1f} "
        f"tokens/s on the host clock ({decode_s / MAMBA_GEN * 1e3:.3f} ms per step, "
        f"median {statistics.median(res.step_s) * 1e3:.3f} ms); peak memory "
        f"{peak / 2**30:.2f} GiB; card: {card}")

    # The same sequence in float32: prompt, the generated tokens, and filler
    # up to a multiple of the chunk (causal: it changes no earlier logit).
    cfg32 = replace(cfg, dtype="float32")
    length = -(-total // cfg.ssm_chunk) * cfg.ssm_chunk
    filler = rng.integers(0, cfg.vocab_size, (MAMBA_B, length - total))
    seq = torch.cat([prompt, torch.as_tensor(res.tokens, device="cuda"),
                     torch.as_tensor(filler, device="cuda")], dim=1)
    with torch.no_grad():
        full, _ = model_lib.forward(params32, {"tokens": seq}, cfg32, use_kernel=True)
        logits, caches = make_prefill_step(cfg32, MAMBA_PROMPT)(
            params32, {"tokens": seq[:, :MAMBA_PROMPT]})
        diffs = [_logit_diff(torch, logits[:, 0], full[:, MAMBA_PROMPT - 1], cfg.vocab_size)]
        caches = transformer.grow_caches(caches, cfg32, total)
        decode = make_decode_step(cfg32, total)
        for t in range(MAMBA_GEN):
            pos = MAMBA_PROMPT + t
            out, caches = decode(params32, seq[:, pos:pos + 1], caches, pos)
            diffs.append(_logit_diff(torch, out[:, 0], full[:, pos], cfg.vocab_size))
        del full, caches
    worst, bad, rel, agree = _summary(diffs)
    log(f"[11 mamba serve] float32 prefill + {MAMBA_GEN} teacher-forced decode steps "
        f"(the recurrence) vs the kernel forward at the same {MAMBA_GEN + 1} positions of "
        f"the same sequence: max abs logit diff {worst:.3e}, {bad} entries outside "
        f"rtol/atol {PARITY_TOL[0]}/{PARITY_TOL[1]}, relative L2 {rel:.3e}, argmax agrees "
        f"{agree:.4%}; card: {card}")
    need(bad == 0, f"mamba float32 decode vs kernel forward: {bad} logits outside tolerance")
    torch.cuda.empty_cache()


def _train_replay(cfg, data, steps):
    """The trainer's control loop on the CPU without the model: the
    simulator, injector and ``observe`` loop of ``FalconTrainer.run``.
    Returns the control plane's event log records."""
    from repro_torch.cluster.injector import FailSlowInjector
    from repro_torch.controlplane import ControlPlane, MitigationResult, event_log_records
    from repro_torch.core.detector import FalconDetect
    from repro_torch.core.planner import DEFAULT_OVERHEADS
    from repro_torch.launch.train import parse_injection, train_simulator

    sim = train_simulator(cfg, data, device="cpu")
    injector = FailSlowInjector([parse_injection(TRAIN_INJECT)])
    plane = ControlPlane(fleet_kwargs={"device": "cpu"})
    plane.register_job("train", sim,
                       detector=FalconDetect(cluster=sim, verify_window=8, device="cpu"),
                       overheads=dict(DEFAULT_OVERHEADS), injector=injector)
    wall = 0.0
    for _ in range(steps):
        injector.apply(sim.state, wall)
        it = sim.iteration_time()
        wall += it
        for ev in plane.observe("train", it, wall):
            if isinstance(ev, MitigationResult) and ev.kind != "relief":
                wall += ev.overhead
    return event_log_records(plane.events)


def phase_train(torch, np, card):
    """Slice 3's train path: ``FalconTrainer`` on mamba2-2.7b at its
    published width on the card (the plain chunked SSD, as the reference
    trains), the control-plane event log held to the CPU replay."""
    from repro_torch.cluster.injector import FailSlowInjector
    from repro_torch.configs.base import get_config
    from repro_torch.controlplane import event_log_records
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import parse_injection, train_simulator
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import FalconTrainer

    cfg = get_config(MAMBA_ARCH)
    data = DataConfig(**TRAIN_DATA)
    want = _train_replay(cfg, data, TRAIN_STEPS)
    kinds = [r["type"] for r in want]
    need("Diagnosis" in kinds and "MitigationResult" in kinds,
         f"the CPU replay raised no diagnosis/mitigation (kinds {kinds})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = FalconTrainer(
        cfg=cfg, data=data, opt_cfg=AdamWConfig(total_steps=TRAIN_STEPS),
        perf_model=train_simulator(cfg, data, device="cuda"),
        injector=FailSlowInjector([parse_injection(TRAIN_INJECT)]),
    )
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    need(trainer.params["embed"]["tok"].is_cuda, "the trainer's parameters are not on the card")
    read = _zero_launches()
    t0 = time.perf_counter()
    hist = trainer.run(TRAIN_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    losses = [r.loss for r in hist]
    need(all(np.isfinite(losses)), f"non-finite training losses: {losses}")
    got = event_log_records(trainer.control.events)
    if json.dumps(got, sort_keys=True) != json.dumps(want, sort_keys=True):
        raise SmokeError(f"train event log differs from the CPU replay: {got} vs {want}")
    applied = [(r.step, r.strategy) for r in hist if r.strategy]
    secs = trainer.step_seconds
    tokens = data.global_batch * data.seq_len
    later = statistics.median(secs[1:])
    log(f"[12 train] FalconTrainer {cfg.name} published width, {TRAIN_STEPS} steps of "
        f"{data.slots} micro-batches x ({data.global_batch // data.slots} x {data.seq_len}) "
        f"tokens, inject {TRAIN_INJECT}: event log identical to the CPU replay "
        f"({len(want)} records: {kinds}); strategies applied {applied}; launches {launches}; "
        f"card: {card}")
    log(f"[12 train] loss curve {[round(x, 4) for x in losses]}")
    log(f"[12 train] init {init_s:.2f} s; {run_s:.2f} s for {TRAIN_STEPS} steps; per step "
        f"(host clock, synchronised) first {secs[0]:.3f} s, median of the rest "
        f"{later:.4f} s ({tokens / later:.0f} tokens/s), max {max(secs[1:]):.3f} s; peak "
        f"memory {peak / 2**30:.2f} GiB; card: {card}")
    del trainer
    torch.cuda.empty_cache()


def phase_times_ssd(torch, card, errs, forward_launches):
    """``ssd_scan`` at the mamba2-2.7b forward shape in bf16 (dt in bf16,
    as the model passes it), its plain version (the sequential recurrence)
    and the model's plain chunked route, beside the bound."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_reference
    from repro_torch.models.ssm import ssd_scan as chunked

    saved = ssd_scan.launches
    b, s, h, p, g, n, q = 1, FORWARD_LEN, 80, 64, 1, 128, 128
    bf = torch.bfloat16
    x, dt, a, bm, cm = _ssd_inputs(torch, 99, (b, s, h, p, g, n), bf)
    dt = dt.to(bf)
    ms, call_ms = _device_ms(torch, lambda: ssd_scan(x, dt, a, bm, cm, chunk=q))
    plain_ms, plain_call = _device_ms(torch, lambda: ssd_scan_reference(x, dt, a, bm, cm),
                                      runs=3, chunk=1, warmup=1)
    chunked_ms, _ = _device_ms(torch, lambda: chunked(x, dt, a, bm, cm, q), runs=10,
                               chunk=2, warmup=2)
    ssd_scan.launches = saved
    # Each input read once, each output written once: x and y, dt (bf16),
    # a (float32), B and C, the final state.
    nbytes = 2 * (2 * b * s * h * p + b * s * h + 2 * b * s * g * n + b * h * p * n) + 4 * h
    # What the function needs per (head, chunk): C Bᵀ and the masked product
    # with x over the lower triangle only, C S_prev and the state update.
    nc, tri = s // q, q * (q + 1) // 2
    flops = b * h * nc * (2 * tri * n + 2 * tri * p + 2 * q * n * p + 2 * q * n * p)
    row = _row("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:82", forward_launches["ssd_scan"],
               errs[("ssd_scan", "bfloat16")], ms, plain_ms, nbytes, flops,
               BF16_FLOP_PER_S, None)
    # The design's own floor: x read twice (chunk states, outputs); each
    # chunk's float32 state written and read, the state entering it (bf16
    # hi and lo planes) written and read; y written once; B, C, dt, the
    # (cum, dt) scratch and the final state.
    state_bytes = 4 * b * h * nc * p * n
    design = (2 * 2 * b * s * h * p + 4 * state_bytes + 2 * b * s * h * p
              + 2 * (2 * b * s * g * n + b * s * h + b * h * p * n) + 3 * 4 * b * h * nc * 2 * q)
    split = _kernel_split(torch, lambda: ssd_scan(x, dt, a, bm, cm, chunk=q))
    ssd_scan.launches = saved
    log(f"[13 times] ssd_scan bf16 B={b} S={s} H={h} P={p} G={g} N={n} chunk={q}: kernel "
        f"{ms:.4f} ms (device, median of >=100; per call with host {call_ms:.4f} ms), plain "
        f"sequential recurrence {plain_ms:.4f} ms (median of 3; per call with host "
        f"{plain_call:.4f} ms), plain chunked route {chunked_ms:.4f} ms, library none; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.2f} GFLOP); the design's floor {design / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({design / 1e6:.1f} MB); {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of the function's bytes; per kernel "
        f"(torch.profiler, mean of 10 calls) {split}; card: {card}")
    need(ms <= SSD_GATE_MS and ms < chunked_ms,
         f"ssd_scan bf16 takes {ms:.4f} ms: above {SSD_GATE_MS} ms or not faster than the "
         f"plain chunked route ({chunked_ms:.4f} ms)")
    del x, dt, a, bm, cm
    return row


def _kernel_split(torch, fn, calls=10):
    """'name us; ...': mean device microseconds per call of each CUDA kernel
    ``fn`` runs, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = (e.name.replace("(anonymous namespace)::", "").split("(")[0]
                    .split("<")[0].split()[-1].split("::")[-1])
            total[name] = total.get(name, 0.0) + e.device_time_total / calls
    return "; ".join(f"{k} {v:.1f} us" for k, v in sorted(total.items(), key=lambda kv: -kv[1]))


# ------------------------------------------------------------------ phase 14
def _decisions(event_log):
    """The decisions of a report's event log (the records' form of
    ``_event_key``): type, job, time, change-point index, root cause,
    components, strategy and status of each flag, diagnosis, mitigation
    action and result."""
    keys = []
    for rec in event_log:
        kind = rec["type"]
        if kind not in ("Flag", "Diagnosis", "MitigationAction", "MitigationResult"):
            continue
        event = rec.get("event") or {}
        keys.append((
            kind, rec["job_id"], rec["time"],
            (rec.get("change_point") or {}).get("index"),
            event.get("root_cause"), tuple(event.get("components", ())),
            rec.get("strategy"), rec.get("status"), rec.get("applied"),
            rec.get("resolved"), rec.get("deduped_from"),
        ))
    return keys


def _first_diff(got, want, path="", rtol=0.0):
    """The first path where two JSON trees differ (None = none): floats
    beyond ``rtol`` relative, anything else unequal."""
    if isinstance(want, dict) and isinstance(got, dict):
        if sorted(got) != sorted(want):
            return f"{path or '/'}: keys {sorted(set(got) ^ set(want))}"
        for k in sorted(want):
            d = _first_diff(got[k], want[k], f"{path}/{k}", rtol)
            if d:
                return d
        return None
    if isinstance(want, list) and isinstance(got, list):
        if len(got) != len(want):
            return f"{path}: length {len(got)} vs {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            d = _first_diff(g, w, f"{path}[{i}]", rtol)
            if d:
                return d
        return None
    if (isinstance(want, float) and isinstance(got, (int, float))
            and not isinstance(got, bool)):
        if abs(got - want) <= rtol * max(abs(got), abs(want)):
            return None
        return f"{path}: {got!r} vs {want!r}"
    return None if got == want and type(got) is type(want) else f"{path}: {got!r} vs {want!r}"


def _report_bytes(report):
    """A report as ``write_report`` serializes it."""
    return (json.dumps(report, indent=1, sort_keys=True) + "\n").encode()


def _hold_report(preset, got, want_bytes):
    """Hold a card report to the committed one; returns the first path at
    which their bytes differ (None = byte identical)."""
    want = json.loads(want_bytes)
    need(_decisions(got["event_log"]) == _decisions(want["event_log"]),
         f"{preset}: decisions differ from the committed report "
         f"({_first_diff(got['event_log'], want['event_log'])})")
    for block in CAMPAIGN_BLOCKS:
        need(got[block] == want[block], f"{preset}: the {block} block differs "
             f"({_first_diff(got[block], want[block])})")
    d = _first_diff(got, want, rtol=CAMPAIGN_RTOL)
    need(d is None, f"{preset}: the report differs beyond {CAMPAIGN_RTOL} relative at {d}")
    return None if _report_bytes(got) == want_bytes else _first_diff(got, want)


def phase_campaigns(torch, card):
    """Slice 7's path: the scenario campaigns through ``run_and_score`` on
    the card with the default backends, held to the committed reports;
    the ``mixed_fleet`` sidecars; a spawned sweep. Returns bocd_step's
    launches over the eight campaigns."""
    from repro_torch.controlplane.plane import ControlPlane
    from repro_torch.kernels.bocd_step import bocd_step
    from repro_torch.kernels.cell_reduce import cell_reduce
    from repro_torch.launch import sweep
    from repro_torch.obs.recorder import write_sidecars
    from repro_torch.scenarios import run_and_score, write_report

    committed = ROOT / "results" / "campaigns"
    out_dir = ROOT / "build" / "chip_smoke_campaigns"
    # Host time of the engine's rolling plane snapshots (one a tick of the
    # shared leg; on the card each copies every cohort's slot state back).
    snaps = {"n": 0, "s": 0.0}
    snapshot = ControlPlane.snapshot

    def timed_snapshot(self):
        t0 = time.perf_counter()
        try:
            return snapshot(self)
        finally:
            snaps["n"] += 1
            snaps["s"] += time.perf_counter() - t0

    ControlPlane.snapshot = timed_snapshot
    total = 0
    t_phase = time.perf_counter()
    try:
        for preset, jobs in CAMPAIGNS:
            want_bytes = (committed / f"{preset}-j{jobs}-s0.json").read_bytes()
            snaps.update(n=0, s=0.0)
            torch.cuda.synchronize()
            bocd_step.launches = 0
            cell_reduce.launches = 0
            t0 = time.perf_counter()
            _, runs, report = run_and_score(preset, n_jobs=jobs, seed=0)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            launches = bocd_step.launches
            cells = cell_reduce.launches
            need(launches > 0, f"{preset}: the campaign launched no bocd_step kernel")
            total += launches
            n_snap, snap_s = snaps["n"], snaps["s"]
            diff = _hold_report(preset, report, want_bytes)
            t0 = time.perf_counter()
            _, _, cpu_report = run_and_score(
                preset, n_jobs=jobs, seed=0, device="cpu", screening_backend="batched",
                reduction_backend="vectorized", fresh=True)
            cpu_s = time.perf_counter() - t0
            need(_report_bytes(cpu_report) == want_bytes,
                 f"{preset}: the CPU eager route's report is not the committed one")
            ticks = report["campaign"]["ticks_run"]
            log(f"[14 campaigns] {preset} -j{jobs} -s0: decisions "
                f"({len(_decisions(report['event_log']))}) and scoring "
                f"equal to the committed report, other floats within {CAMPAIGN_RTOL}; "
                f"bytes {'identical' if diff is None else 'differ first at ' + diff}; "
                f"ticks {ticks}; bocd_step launches {launches}, cell_reduce {cells}; "
                f"card {card_s:.3f} s, CPU eager route {cpu_s:.3f} s; engine "
                f"snapshots {n_snap} taking {snap_s * 1e3:.1f} ms host "
                f"({snap_s * 1e6 / max(n_snap, 1):.1f} us each); card: {card}")
    finally:
        ControlPlane.snapshot = snapshot
    campaigns_s = time.perf_counter() - t_phase

    # mixed_fleet with its observability sidecars: the tracer runs on the
    # simulated clock, so the sidecars are byte for byte the committed ones.
    preset, jobs = CAMPAIGNS[-1]
    base = f"{preset}-j{jobs}-s0"
    t0 = time.perf_counter()
    spec, runs, report = run_and_score(preset, n_jobs=jobs, seed=0, obs=True)
    obs_s = time.perf_counter() - t0
    _hold_report(preset, report, (committed / f"{base}.json").read_bytes())
    write_report(report, str(out_dir))
    paths = write_sidecars(spec, runs, report, out_dir=str(out_dir))
    for kind in ("trace", "metrics"):
        need(Path(paths[kind]).read_bytes() == (committed / f"{base}.{kind}.json").read_bytes(),
             f"{preset}: the {kind} sidecar differs from the committed one")
    log(f"[14 campaigns] {preset} --obs on the card: trace and metrics sidecars byte "
        f"identical to the committed ones ({obs_s:.3f} s); card: {card}")

    # A seed sweep over a spawn pool: each worker opens its own CUDA context.
    name, jobs, seeds = SWEEP
    t0 = time.perf_counter()
    table = sweep.run_sweep(name, n_jobs=jobs, seeds=seeds, workers=SWEEP_WORKERS)
    sweep_s = time.perf_counter() - t0
    path = Path(sweep.write_sweep(table, str(out_dir)))
    want = ROOT / "results" / "sweeps" / f"{name}-j{jobs}-seeds{seeds}.json"
    need(json.loads(path.read_text()) == json.loads(want.read_text()),
         f"the {name} sweep differs from the committed table "
         f"({_first_diff(json.loads(path.read_text()), json.loads(want.read_text()))})")
    same = path.read_bytes() == want.read_bytes()
    log(f"[14 campaigns] sweep {name} -j{jobs} --seeds {seeds} --workers {SWEEP_WORKERS} "
        f"(spawn) on the card: equal to the committed table (bytes "
        f"{'identical' if same else 'differ'}), {sweep_s:.3f} s; card: {card}")
    log(f"[14 campaigns] {len(CAMPAIGNS)} presets in {campaigns_s:.1f} s (card and CPU "
        f"routes); bocd_step launches over the card campaigns {total}")
    return total


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
        errs.update(phase_attention_kernels(torch))
        errs.update(phase_ssd_kernel(torch))
        launches = phase_main_path(torch, np, card, phase_references(np))
        cfg, params, prompt, serve_launches = phase_serve(torch, np, card)
        forward_launches, tokens = phase_forward(torch, np, card, cfg, params)
        rows = phase_times(torch, np, card, errs, launches)
        rows += phase_times_attention(torch, card, errs, serve_launches,
                                      forward_launches)
        phase_parity(torch, card, cfg, params, prompt, tokens)
        del params, prompt, tokens   # granite-3-8b's tensors
        torch.cuda.empty_cache()
        mcfg, mparams, mparams32, mamba_launches = phase_mamba_forward(torch, np, card)
        phase_mamba_serve(torch, np, card, mcfg, mparams, mparams32)
        del mparams, mparams32
        torch.cuda.empty_cache()
        rows.append(phase_times_ssd(torch, card, errs, mamba_launches))
        phase_train(torch, np, card)
        rows[0]["campaign_launches"] = phase_campaigns(torch, card)
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
