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
   0, a cache length off the split grid, MHA rep 1 at the OLMoE serve
   shape) and ``flash_attention`` (causal,
   non-causal, a window, a ragged Sq, the 4,096-token forward and the serve
   prefills of phases 6 and 16 and of the benchmark, up to (16, 3,968,
   32/8, 128)) in float32 and bfloat16; ``ssd_scan``
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
   ``flash_attention`` launched 40 times (the prefill) and ``flash_decode``
   40 x 64 times, finite logits, the FALCON onset
   of a CPU run of the same latency loop (token 36, gpu_degradation on
   gpu:1);
7. forward: ``model.forward(use_kernel=True)`` over a 4,096-token prompt,
   ``flash_attention`` launched 40 times, its bf16 logits' difference from
   the plain blocked attention reported;
8. times: median CUDA-event time per call of each kernel, of its plain
   version and, where one PyTorch call computes the same function, of
   that call, at the paths' shapes (the attention kernels also at
   olmoe-1b-7b's: 16/16 heads, rep 1), beside the bound, with its rate and its
   ratios to that call and to the bound; the CUDA kernels of one
   ``bocd_step`` call (torch.profiler), its time held to BOCD_GATE_MS;
   ``cell_reduce`` on the packed float64 cells at (8, 160, 8) (held to
   CELL_GATE_MS) and (16, 128, 8) beside an empty launch, and one simulator
   evaluation with the host included, the packed route (one upload, one
   launch, one download) against the unpacked one in turns, held to
   EVAL_RATIO;
9. parity at the published width, kernel route against plain route: the
   prefill of phase 6's prompt (last-token logits and every cache leaf),
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
    the card equals ``results/sweeps/single_gpu_throttle-j1-seeds3.json``;
15. the what-if layer (slice 8): ``repro_torch.launch.whatif``'s ``main``
    on the card with the default backends (the CUDA ``bocd_step`` screen in
    float32) for the ``single_gpu_throttle -j1`` leave-one-out sidecar, its
    explain artifact and 3-seed tuning file, and the ``mixed_fleet -j8``
    leave-one-out sidecar, each held to the committed file (equal decision
    identities, causes, episodes and tuner probes, every float within
    CAMPAIGN_RTOL; byte identity reported), then on the CPU route
    (``--device cpu``: the committed bytes) for its wall seconds;
    ``bocd_step`` launches and the replay stats are reported;
16. olmoe-1b-7b (slice 8's MoE) at its published width: ``serve`` with 8
    requests x (1,024 prompt + 64 generated), ``use_kernel`` and
    ``gpu:1:0.5:0.5:200``: ``flash_attention`` launched 16 times (the
    prefill) and ``flash_decode`` 16 x 64 times, finite
    logits, the FALCON onset of the CPU latency loop (token 31); a forward
    over 4,096 tokens with the config's window (4,096), ``flash_attention``
    launched 16 times, the bf16 plain route reported; in float32 (weights
    upcast) each MoE layer's routing recomputed in both routes, the routing
    flips counted and printed, and the logits of the rows no flip reaches
    held to PARITY_TOL. The model's tensors are released after;
17. the four example twins (``examples/torch_*.py``) through their
    ``main`` on the card, each ending with its reference's asserts:
    ``torch_train_100m_falcon`` at falcon-demo-100m's published width (8
    layers, d_model 768, 12/4 heads, 32k vocab) for 200 steps on the (2 TP,
    4 DP, 2 PP) simulator, loss decreasing, its strategy timeline and event
    log equal to a CPU replay of the same simulator, injector and control
    plane, ``cell_reduce`` launched; ``torch_quickstart``,
    ``torch_detect_from_trace`` and ``torch_serve_decode``. The twins follow
    their references, so ``cell_reduce`` is the one kernel on these paths:
    the trainers' per-job detector is the host's scalar BOCD, the detect
    twin is host work and the serve twin decodes on the plain route;
18. the mesh on the one card: 4 spawned ranks joined by gloo on CUDA
    tensors (NCCL refuses two ranks on one device), the collectives gloo
    serves for them probed and printed; in float32 to PARITY_TOL: (F)
    granite-3-8b at published width and depth over (data 1, model 4), heads
    sharded: the sharded prefill of 8 x 1,024 tokens, its last-token logits
    and every rank's cache shards equal to the unsharded plain prefill's (run
    first in a child process and freed); (A) from (F)'s caches grown to 1,088
    slots, 8 decode steps with the kernel route, logits equal to the unsharded
    plain route's, ``flash_decode`` launched 40 x 8 times on every rank, the
    decode ms a step sharded and unsharded and the gloo share printed; (B)
    granite-20b smoke (kv 1) with the cache sequence sharded over model (B 4)
    and folded over (data, model) (B 1), both routes, equal to the unsharded
    plain route; (C) one olmoe-1b-7b MoE layer at published width,
    expert-parallel over (data 2, model 2) at capacity factor 8, equal to the
    local dispatch; (D) one adaptive step of falcon-demo-100m at published
    width over (data 2, model 2) with counts [4, 2], equal to the one-process
    weighted step and each leaf's change within MESH_STEP_RTOL of the
    one-process change (the step at counts [1, 1] must miss it); (G) one even
    train step of falcon-demo-100m at published width over (2, 2),
    model-sharded with ZeRO-1 moments (``make_train_step`` under the mesh),
    each leaf's change within MESH_STEP_RTOL of the one-process step's
    (STEP_ULPS float32 units forgiven; the step on the first slot alone must
    miss it); (H) the gradients of one olmoe-1b-7b MoE layer and of its input
    through the expert-parallel path equal to the local dispatch's on each
    data shard; (E) ``remap_mesh``;
19. the dry-run twin on the card (``repro_torch.launch.dryrun``, in a child
    process over a fake process group of 256 or 512 ranks): granite-3-8b at
    all four shapes, mamba2-2.7b and olmoe-1b-7b training, jamba's prefill
    and granite-3-8b training over 2x16x16; each record's argument bytes
    equal to the shard-shape sum worked out here from the port's partition
    functions, its peak within the card's memory and its operations at least
    DRYRUN_FLOPS_SHARE of the model's per device; beside each peak the
    ``--device cpu`` route's MemTracker estimate, run at the lowest priority
    beside the card child only, so that no phase timed on the host's clock
    shares the host with it (stopped at DRYRUN_CPU_DEADLINE if not done).

Any failure exits non-zero. The last two lines are a JSON object with one
entry per kernel (``bocd_step``'s also carries ``campaign_launches`` and
``whatif_launches``, its launches in phases 14 and 15; ``flash_decode``'s
and ``flash_attention``'s ``olmoe_launches``, theirs in phase 16; every
kernel's ``example_launches``, its launches over the twins of phase 17;
``flash_decode``'s ``mesh_launches``, its launches over the ranks of
phase 18 (A)) and
``{"ok": true, "device": {...}}``. The script imports
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
# Table 4; 288 KB of float64 cells); the same at DP 1,024, whose blocks
# take their 128 dp columns in several passes; and (2, 4, 2), the
# (2 TP, 4 DP, 2 PP) job of phase 17's train twin.
# Gates: the kernel's device median at (8, 160, 8) on the packed float64
# cells, and one evaluation with the host included, packed route against
# the unpacked one (five float32 copies, the kernel, cat, .cpu()) in turns.
CELL_SHAPES = ((8, 160, 8), (2, 2, 2), (16, 128, 8), (16, 1024, 8), (2, 4, 2))
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
# n = 4,096. Phase 3 prints both readings at every shape of FAULT_LEN
# tokens or more; the fault reading leaves out the key tile at half the
# keys (tile 16, keys 2,048-2,175, at 4,096).
ATT_ROW_REL = 2e-2
FAULT_LEN = 1024
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

# Slice 8's paths. The what-if CLI's committed artifacts: (label, the CLI's
# arguments as the reference was given them, the committed file). Run from
# the checkout's root, so the explain artifact embeds the same baseline
# path.
SGT_REPORT = "results/campaigns/single_gpu_throttle-j1-s0.json"
WHATIF_RUNS = (
    ("single_gpu_throttle -j1 leave-one-out", ["--report", SGT_REPORT, "--leave-one-out"],
     "results/campaigns/single_gpu_throttle-j1-s0.attribution.json"),
    ("single_gpu_throttle -j1 explain",
     ["--preset", "single_gpu_throttle", "--jobs", "1", "--seed", "0", "--explain", SGT_REPORT],
     "results/whatif/explain-single_gpu_throttle-j1-s0.json"),
    ("single_gpu_throttle -j1 3-seed tuning",
     ["--preset", "single_gpu_throttle", "--jobs", "1", "--seed", "0", "--tune",
      "breakeven_scale", "prediction_margin", "--tune-seeds", "3"],
     "results/whatif/single_gpu_throttle-j1-s3seeds-tuning.json"),
    ("mixed_fleet -j8 leave-one-out",
     ["--report", "results/campaigns/mixed_fleet-j8-s0.json", "--leave-one-out"],
     "results/campaigns/mixed_fleet-j8-s0.attribution.json"),
)
# olmoe-1b-7b at its published width (16 layers, d_model 2048, 16 heads /
# 16 KV heads of 128, 64 experts top-8, expert width 1,024), random weights
# from seed 0: serving as granite's (8 x (1,024 + 64), use_kernel) with a
# fail-slow that fires inside 64 tokens (the modeled time per token is
# ~0.0168 s), and a forward over FORWARD_LEN tokens with the config's
# sliding window (4,096) passed down as the model passes it.
OLMOE_ARCH = "olmoe-1b-7b"
OLMOE_INJECT = "gpu:1:0.5:0.5:200"
OLMOE_EVENT = (31, "gpu_degradation", ["gpu:1"])
# The widest gap between the k-th and (k+1)-th router probabilities that a
# float32 routing flip may show: the two routes' router inputs differ by
# attention's summation order (~1e-6 relative), which moves a probability
# of ~1/64 by ~1e-8; sound near-ties read ~1e-7, a typical gap ~2e-3.
FLIP_GAP = 1e-5


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
    leaving out the key tile at half the keys (128 keys) would get wrong:
    the plain version's math with those keys masked for every later row,
    against ``want``. Returns (tile, least, most) over those rows."""
    b, sq, h, hd = q.shape
    skv, rep = k.shape[1], h // k.shape[2]
    tile = skv // 256
    k0 = tile * 128
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
    return tile, float(rel.min()), float(rel.max())


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
    ("MHA rep 1 (the OLMoE serve shape)", 8, 1088, 16, 16, 128, 1088),
    ("a rank of granite-3-8b over model 4 (phase 18)", 8, 1088, 8, 2, 128, 1025),
)
ATTENTION_CASES = (   # label, B, Sq, Skv, H, KVH, hd, causal, window
    ("causal GQA", 1, 256, 256, 4, 2, 64, True, 0),
    ("non-causal", 1, 128, 128, 2, 2, 64, False, 0),
    ("window 48", 1, 200, 200, 4, 2, 128, True, 48),
    ("ragged Sq 130", 2, 130, 130, 4, 4, 128, True, 0),
    ("MQA, Sq 96 != Skv 160, non-causal", 1, 96, 160, 8, 1, 64, False, 0),
    ("the forward shape", 1, 4096, 4096, 32, 8, 128, True, 0),
    # The serve prefills' (window 0: serve_window keeps the config's window
    # for contexts past 64k): phase 6's, phase 16's (OLMoE, MHA), the
    # benchmark's (granite-3-8b.serve-rag); and OLMoE's with its window.
    ("the phase 6 prefill", 8, 1024, 1024, 32, 8, 128, True, 0),
    ("the phase 16 prefill", 8, 1024, 1024, 16, 16, 128, True, 0),
    ("OLMoE's window 4,096", 8, 1024, 1024, 16, 16, 128, True, 4096),
    ("the benchmark's prefill", 16, 3968, 3968, 32, 8, 128, True, 0),
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
            # one sequence at a time: the plain version holds (H, Sq, Skv)
            # float32 scores, 2 GB at the benchmark's 3,968 tokens
            want = torch.cat([flash_attention_reference(q[j:j + 1], k[j:j + 1], v[j:j + 1],
                                                        causal=causal, window=window)
                              for j in range(b)])
            torch.cuda.synchronize()
            e = _att_err(torch, f"flash_attention {dt_name} {label}", got, want, dt_name)
            worst = max(worst, e)
            parts.append(f"{label} {e:.2e}")
            if dt_name == "bfloat16":
                rel = _row_rel(torch, f"flash_attention {label}", got, want)
                row_worst = max(row_worst, rel)
                if sq >= FAULT_LEN:
                    # every such case is causal with Sq = Skv and no window
                    # narrower than the prompt, as the fault reading takes;
                    # it reads the batch's last sequence
                    tile, least, most = _one_tile_fault(torch, q[-1:], k[-1:], v[-1:],
                                                        want[-1:])
                    need(least > ATT_ROW_REL,
                         f"flash_attention {label}: a row missing key tile {tile} reads "
                         f"{least:.3e}, within the row limit {ATT_ROW_REL:.0e}")
                    log(f"[3 kernels] flash_attention bf16 {label} ({b}, {sq}, {h}/{kvh}, "
                        f"{hd}): worst row rel L2 {rel:.3e} (kernel vs plain); rows "
                        f"missing key tile {tile} read {least:.3e}-{most:.3e}; limit "
                        f"{ATT_ROW_REL:.0e}")
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


def _cache_diff(torch, got, want):
    """(max abs difference, entries outside PARITY_TOL, worst leaf's
    relative L2 difference) of two prefills' caches, leaf by leaf."""
    need(sorted(got) == sorted(want), f"cache keys {sorted(got)} vs {sorted(want)}")
    worst, bad, rel = 0.0, 0, 0.0
    rtol, atol = PARITY_TOL
    for key, leaves in want.items():
        need(sorted(got[key]) == sorted(leaves), f"cache leaves of {key} differ")
        for name, w in leaves.items():
            g, w = got[key][name].double(), w.double()
            need(g.shape == w.shape and bool(torch.isfinite(g).all()),
                 f"cache {key}/{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or "
                 "not finite")
            diff = (g - w).abs()
            worst = max(worst, float(diff.max()))
            bad += int((diff > atol + rtol * w.abs()).sum())
            rel = max(rel, float(torch.linalg.vector_norm(g - w)
                                 / torch.linalg.vector_norm(w)))
    return worst, bad, rel


def _teacher_forced(torch, cfg, params, prompt):
    """Prefill ``prompt`` on the kernel route and on the plain route, then
    decode TEACHER_STEPS tokens with the kernel route from the plain
    prefill's caches; before each step the plain route runs on a copy of the
    same caches with the same token (the plain route's token is fed to
    both). Returns the prefills' ``_logit_diff`` and ``_cache_diff``
    results and the per-step ``_logit_diff`` results."""
    from repro_torch.models import transformer
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    total = SERVE_PROMPT + TEACHER_STEPS
    out = []
    with torch.no_grad():
        got, kern_caches = make_prefill_step(cfg, SERVE_PROMPT, use_kernel=True)(
            params, {"tokens": prompt})
        logits, caches = make_prefill_step(cfg, SERVE_PROMPT)(params, {"tokens": prompt})
        prefill = (_logit_diff(torch, got, logits, cfg.vocab_size),
                   _cache_diff(torch, kern_caches, caches))
        del got, kern_caches
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
    return prefill, out


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

    need(launches["flash_attention"] == cfg.num_layers,
         f"the prefill launched flash_attention {launches['flash_attention']} times, "
         f"expected {cfg.num_layers}")
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


def _log_prefill(dt_name, prefill):
    (worst, bad, rel, agree), (c_worst, c_bad, c_rel) = prefill
    held = (f", {bad} logits and {c_bad} cache entries outside rtol/atol "
            f"{PARITY_TOL[0]}/{PARITY_TOL[1]}" if dt_name == "float32" else "")
    log(f"[9 parity] {dt_name} prefill of phase 6's prompt ({SERVE_B} x {SERVE_PROMPT}), "
        f"kernel vs plain route: last-token logits max abs diff {worst:.3e}, relative "
        f"L2 {rel:.3e}, argmax agrees {agree:.4%}; caches max abs diff {c_worst:.3e}, "
        f"worst leaf's relative L2 {c_rel:.3e}{held}")


def phase_parity(torch, card, cfg, params, prompt, tokens):
    """Kernel route vs plain route at the published width: the prefill of
    phase 6's prompt (last-token logits and every cache leaf), teacher-forced
    decode on the same caches and the 4,096-token forward. bf16 reported;
    float32 (weights upcast exactly) held to PARITY_TOL."""
    from dataclasses import replace

    from repro_torch.models import model as model_lib

    prefill, diffs = _teacher_forced(torch, cfg, params, prompt)
    _log_prefill("bfloat16", prefill)
    worst, bad, rel, agree = _summary(diffs)
    log(f"[9 parity] bf16 teacher-forced decode, kernel vs plain route on the same "
        f"caches, {TEACHER_STEPS} steps: max abs logit diff {worst:.3e}, relative L2 "
        f"{rel:.3e}, argmax agrees {agree:.4%}")
    cfg32 = replace(cfg, dtype="float32")
    params32 = _as_float(torch, params)
    torch.cuda.empty_cache()
    prefill32, diffs = _teacher_forced(torch, cfg32, params32, prompt)
    _log_prefill("float32", prefill32)
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
    need(prefill32[0][1] == 0, f"float32 prefill: {prefill32[0][1]} logits outside tolerance")
    need(prefill32[1][1] == 0,
         f"float32 prefill: {prefill32[1][1]} cache entries outside tolerance")
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
    # flash_decode at the serve's last step: B = 8, 1,088 valid of 1,088
    # (granite's 32/8 heads, the row's shape; 32,768 positions; OLMoE's
    # 16/16 heads, rep 1).
    b, hd = SERVE_B, 128
    for h, kvh, skv in ((32, 8, SERVE_PROMPT + SERVE_GEN), (32, 8, 32768),
                        (16, 16, SERVE_PROMPT + SERVE_GEN)):
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
        if (h, kvh, skv) == (32, 8, SERVE_PROMPT + SERVE_GEN):
            out.append(row)
        del q, k, v, kt, vt
    # flash_attention at the forward's shape (granite's 32/8 heads, the
    # row's shape), and at OLMoE's (16/16 heads, its window of 4,096 passed
    # as the model passes it: every key of a causal row is inside it, so
    # SDPA's causal call computes the same function).
    b, s, hd = 1, FORWARD_LEN, 128
    for h, kvh, window in ((32, 8, 0), (16, 16, FORWARD_LEN)):
        q = _normal(torch, 93, (b, s, h, hd), bf)
        k = _normal(torch, 94, (b, s, kvh, hd), bf)
        v = _normal(torch, 95, (b, s, kvh, hd), bf)
        nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
        flops = 4 * b * h * hd * (s * (s + 1) // 2)
        ms, call_ms = _device_ms(
            torch, lambda: flash_attention(q, k, v, causal=True, window=window), runs=30)
        plain_ms, _ = _device_ms(
            torch, lambda: flash_attention_reference(q, k, v, causal=True, window=window),
            runs=30)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = _library_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), "flash_attention sdpa")
        row = _row("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:91",
                   forward_launches["flash_attention"], errs[("flash_attention", "bfloat16")],
                   ms, plain_ms, nbytes, flops, BF16_FLOP_PER_S, lib_ms)
        if window == 0:
            out.append(row)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[8 times] flash_attention bf16 causal B={b} S={s} H={h} KVH={kvh} hd={hd} "
            f"window={window}: kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s; "
            f"{_ratios(row, lib_ms)}), plain {plain_ms:.4f} ms, sdpa {lib} (device, median "
            f"of >=30); per call with host {call_ms:.4f} ms; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {flops / 1e9:.1f} GFLOP); card: {card}")
        del q, k, v, qt, kt, vt
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


# ------------------------------------------------------------------ phase 15
def _whatif_ids(rows):
    return [(r["job_id"], r["strategy"], r["time_s"], r["cause"]) for r in rows]


def _hold_whatif(label, got_bytes, want_bytes):
    """Hold a what-if artifact made on the card to the committed one: the
    same decision identities, ``per_cause`` causes and episodes, tuning
    evaluations (knob, value), every float within CAMPAIGN_RTOL relative.
    Returns the first path at which the bytes differ (None = identical)."""
    got, want = json.loads(got_bytes), json.loads(want_bytes)
    if "per_decision" in want:
        need(_whatif_ids(got["per_decision"]) == _whatif_ids(want["per_decision"]),
             f"{label}: the decisions differ from the committed artifact "
             f"({_first_diff(got['per_decision'], want['per_decision'])})")
    if "per_cause" in want:
        need(sorted(got["per_cause"]) == sorted(want["per_cause"]),
             f"{label}: causes {sorted(got['per_cause'])} vs {sorted(want['per_cause'])}")
        for cause, row in want["per_cause"].items():
            need(got["per_cause"][cause].get("episodes") == row.get("episodes"),
                 f"{label}: the episodes of {cause} differ")
    if "evaluations" in want:
        pairs = [(e["knob"], e["value"]) for e in want["evaluations"]]
        need([(e["knob"], e["value"]) for e in got["evaluations"]] == pairs,
             f"{label}: the tuner probed other knob values")
        need(got["tuned"] == want["tuned"], f"{label}: tuned {got['tuned']} vs {want['tuned']}")
    d = _first_diff(got, want, rtol=CAMPAIGN_RTOL)
    need(d is None, f"{label}: the artifact differs beyond {CAMPAIGN_RTOL} relative at {d}")
    return None if got_bytes == want_bytes else _first_diff(got, want)


def phase_whatif(torch, card):
    """Slice 8's what-if path: ``python -m repro_torch.launch.whatif`` (its
    ``main``) on the card with the default backends (the CUDA
    ``bocd_step`` screen in float32 on the card) for each of WHATIF_RUNS,
    held to the committed artifact, then the same on the CPU route
    (``--device cpu``, the float64 ``torch`` screen: the committed bytes)
    for its wall seconds. Returns bocd_step's launches over the card runs."""
    import os

    from repro_torch.kernels.bocd_step import bocd_step
    from repro_torch.kernels.cell_reduce import cell_reduce
    from repro_torch.launch import whatif
    from repro_torch.whatif import WhatIfEngine

    out_dir = ROOT / "build" / "chip_smoke_whatif"
    engines = []
    init = WhatIfEngine.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        engines.append(self)

    cwd = os.getcwd()
    os.chdir(ROOT)
    WhatIfEngine.__init__ = recording_init
    total, t_phase = 0, time.perf_counter()
    try:
        for i, (label, argv, committed) in enumerate(WHATIF_RUNS):
            want_bytes = (ROOT / committed).read_bytes()
            secs, outs = {}, {}
            for route, dev in (("card", "cuda"), ("cpu", "cpu")):
                path = out_dir / f"{i}-{route}.json"
                engines.clear()
                torch.cuda.synchronize()
                bocd_step.launches = cell_reduce.launches = 0
                t0 = time.perf_counter()
                rc = whatif.main([*argv, "--device", dev, "--quiet", "--out", str(path)])
                torch.cuda.synchronize()
                secs[route] = time.perf_counter() - t0
                need(rc == 0, f"{label} on {dev}: the CLI exited {rc}")
                outs[route] = path.read_bytes()
                if route == "card":
                    launches, cells = bocd_step.launches, cell_reduce.launches
                    stats = {k: sum(e.stats[k] for e in engines)
                             for k in ("variants", "variant_job_runs", "cache_hits")}
                    n_engines = len(engines)
            need(outs["cpu"] == want_bytes,
                 f"{label}: the CPU route's artifact is not the committed one")
            need(launches > 0, f"{label}: no bocd_step kernel was launched")
            total += launches
            diff = _hold_whatif(label, outs["card"], want_bytes)
            got = json.loads(outs["card"])
            head = ""
            if "totals" in got:
                head = f"mitigated {got['totals']['mitigated_pct']} % of the slowdown; "
            elif "objective_tuned_pct" in got:
                head = (f"objective {got['objective_default_pct']} -> "
                        f"{got['objective_tuned_pct']} %; ")
            log(f"[15 what-if] {label} on the card: equal to {committed} (decisions, "
                f"causes and episodes; floats within {CAMPAIGN_RTOL}); bytes "
                f"{'identical' if diff is None else 'differ first at ' + diff}; {head}"
                f"{n_engines} engine(s), replay stats {stats}; bocd_step launches "
                f"{launches}, cell_reduce {cells}; card {secs['card']:.3f} s, CPU route "
                f"{secs['cpu']:.3f} s ({secs['card'] / secs['cpu']:.2f}x); card: {card}")
    finally:
        WhatIfEngine.__init__ = init
        os.chdir(cwd)
    log(f"[15 what-if] {len(WHATIF_RUNS)} artifacts in {time.perf_counter() - t_phase:.1f} s "
        f"(card and CPU routes); bocd_step launches over the card runs {total}")
    return total


# ------------------------------------------------------------------ phase 16
def _routing_recorder(torch):
    """Wrap ``moe.apply_moe`` (the model looks it up at every call) so each
    MoE layer's input is kept and its routing recomputed with ``moe.route``:
    per call, the input (T, D), the sorted top-k expert set and the k-th and
    (k+1)-th probabilities of every token. Returns (records, restore)."""
    from repro_torch.models import layers, moe

    real, records = moe.apply_moe, []

    def recording(p, x, cfg):
        with torch.no_grad():
            flat = x.reshape(-1, x.shape[-1])
            hn = layers.rmsnorm(flat, p["norm"], cfg.norm_eps)
            logits = layers.matmul(hn, p["router"])
            _, idx, _ = moe.route(logits, cfg.top_k, n_real=cfg.num_experts)
            probs = torch.softmax(logits.float(), dim=-1)
            top = torch.sort(probs, dim=-1, descending=True, stable=True).values
            records.append((flat.clone(), idx.sort(dim=-1).values,
                            top[:, cfg.top_k - 1:cfg.top_k + 1]))
        return real(p, x, cfg)

    moe.apply_moe = recording

    def restore():
        moe.apply_moe = real

    return records, restore


def _routing_flips(kern, plain):
    """(layer, token, k-th/(k+1)-th probabilities of both routes, primary)
    of every token whose top-k expert set differs between the two routes.
    A flip is primary when no flip of an earlier layer reaches it (one at a
    token at or before it: attention is causal); later ones may follow from
    a primary flip's changed output by any margin."""
    flips, reach = [], None   # reach: the first flipped token of the earlier layers
    for layer, ((_, ik, pk), (_, ip, pp)) in enumerate(zip(kern, plain)):
        rows = (ik != ip).any(dim=-1).nonzero().flatten().tolist()
        for t in rows:
            flips.append((layer, t, pk[t].tolist(), pp[t].tolist(), reach is None or t < reach))
        if rows:
            reach = min(rows) if reach is None else min(reach, min(rows))
    return flips


def phase_olmoe(torch, np, card):
    """Slice 8's model path: olmoe-1b-7b (OLMOE_ARCH) at its published
    width, random weights from seed 0. (a) ``serve`` with ``use_kernel``
    and a fail-slow: ``flash_decode`` launched once per layer and token,
    finite logits, the FALCON onset of the CPU latency loop. (b)
    ``model.forward(use_kernel=True)`` with the config's window:
    ``flash_attention`` launched once per layer; in bf16 the plain route's
    logits are reported; in float32 (weights upcast exactly) every MoE
    layer's input is kept and its routing recomputed in both routes. The
    tokens whose top-k sets differ (routing flips) are counted and printed;
    a primary flip (see ``_routing_flips``) whose k-th and (k+1)-th
    probabilities lie farther apart than FLIP_GAP in either route fails.
    Each MoE layer's input rows that no flip of an earlier layer reaches
    (every row of layer 0), and the logits of the rows before the first
    flipped token, are held to PARITY_TOL. The model's tensors are released
    after. Returns the launches of (a) and (b)."""
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as model_lib

    cfg = get_config(OLMOE_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)),
                             device="cuda")
    ref_events = _falcon_reference(cfg, inject=OLMOE_INJECT)
    need([e[:3] for e in ref_events] == [OLMOE_EVENT],
         f"the CPU latency loop flags {[e[:3] for e in ref_events]}, expected {[OLMOE_EVENT]}")

    # (a) serving
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _zero_launches()
    res = serve(cfg, params, prompt, gen=SERVE_GEN, use_kernel=True, inject=[OLMOE_INJECT])
    torch.cuda.synchronize()
    serve_launches = read()
    peak = torch.cuda.max_memory_allocated()
    need(serve_launches["flash_attention"] == cfg.num_layers,
         f"the prefill launched flash_attention {serve_launches['flash_attention']} "
         f"times, expected {cfg.num_layers}")
    need(serve_launches["flash_decode"] == cfg.num_layers * SERVE_GEN,
         f"flash_decode launched {serve_launches['flash_decode']} times, expected "
         f"{cfg.num_layers} x {SERVE_GEN}")
    need(bool(torch.isfinite(res.logits.float()).all()), "olmoe serve: non-finite logits")
    need(bool(torch.isfinite(res.prefill_logits.float()).all()),
         "olmoe serve: non-finite prefill logits")
    need(res.tokens.shape == (SERVE_B, SERVE_GEN), f"olmoe serve: tokens {res.tokens.shape}")
    got = [(step, ev.root_cause.value, list(ev.components), ev.t_healthy, ev.t_slow)
           for step, ev in res.events]
    need(got == ref_events, f"olmoe serve flags {got}, the CPU loop {ref_events}")
    decode_s = sum(res.step_s)
    log(f"[16 olmoe] {cfg.name} published width ({n_params / 1e9:.3f} B parameters, bf16, "
        f"init {init_s:.2f} s), {SERVE_B} requests x ({SERVE_PROMPT} prompt + {SERVE_GEN} "
        f"generated), use_kernel, inject {OLMOE_INJECT}: launches {serve_launches}; FALCON "
        f"flags {got[0][1]} on {got[0][2]} at token {got[0][0]} ({got[0][3]:.4f} s -> "
        f"{got[0][4]:.4f} s), the same as the CPU latency loop; logits finite; card: {card}")
    log(f"[16 olmoe] prefill {res.prefill_s:.4f} s (host clock, synchronised); decode "
        f"{SERVE_B * SERVE_GEN / decode_s:.1f} tokens/s on the host clock "
        f"({decode_s / SERVE_GEN * 1e3:.3f} ms per step, median "
        f"{statistics.median(res.step_s) * 1e3:.3f} ms); peak memory {peak / 2**30:.2f} GiB; "
        f"card: {card}")
    del res, prompt

    # (b) the forward, bf16: kernel route, launches; the plain route beside it
    window = cfg.sliding_window
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                               (1, FORWARD_LEN)), device="cuda")
    batch = {"tokens": tokens}
    with torch.no_grad():
        torch.cuda.synchronize()
        read = _zero_launches()
        t0 = time.perf_counter()
        got, aux = model_lib.forward(params, batch, cfg, window=window, use_kernel=True)
        torch.cuda.synchronize()
        kern_s = time.perf_counter() - t0
        fwd_launches = read()
        t0 = time.perf_counter()
        want, _ = model_lib.forward(params, batch, cfg, window=window)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    need(fwd_launches["flash_attention"] == cfg.num_layers,
         f"flash_attention launched {fwd_launches['flash_attention']} times, expected "
         f"{cfg.num_layers}")
    need(bool(torch.isfinite(aux)), "olmoe forward: non-finite aux loss")
    worst, _, rel, agree = _logit_diff(torch, got, want, cfg.vocab_size)
    log(f"[16 olmoe] bf16 forward over (1, {FORWARD_LEN}) tokens, window {window}, "
        f"use_kernel: launches {fwd_launches}; aux loss {float(aux):.4f}; vs the plain blocked "
        f"attention: max abs logit diff {worst:.3e}, relative L2 {rel:.3e}, argmax agrees on "
        f"{agree:.4%} of positions; {kern_s:.3f} s kernel route, {plain_s:.3f} s plain route "
        f"(host clock); card: {card}")
    del got, want

    # float32: routing flips counted and bounded, the rows no flip reaches held
    cfg32 = replace(cfg, dtype="float32")
    params32 = _as_float(torch, params)
    del params
    torch.cuda.empty_cache()
    routes = {}
    with torch.no_grad():
        for name, use_kernel in (("kernel", True), ("plain", False)):
            records, restore = _routing_recorder(torch)
            try:
                logits, _ = model_lib.forward(params32, batch, cfg32, window=window,
                                              use_kernel=use_kernel)
            finally:
                restore()
            routes[name] = (logits, records)
    (got, rec_k), (want, rec_p) = routes["kernel"], routes["plain"]
    need(len(rec_k) == len(rec_p) == cfg.num_layers,
         f"routing recorded for {len(rec_k)}/{len(rec_p)} layers, expected {cfg.num_layers}")
    flips = _routing_flips(rec_k, rec_p)
    primary = [f for f in flips if f[4]]
    wide = [f for f in primary if max(f[2][0] - f[2][1], f[3][0] - f[3][1]) > FLIP_GAP]
    log(f"[16 olmoe] float32 forward, kernel vs plain route: routing flips (top-{cfg.top_k} "
        f"sets that differ) {len(flips)}, {len(primary)} primary, in "
        f"{len({f[1] for f in flips})} tokens over {len({f[0] for f in flips})} layers: "
        + ("; ".join(f"layer {layer} token {t}{' (primary)' if first else ''} p_k,p_k+1 "
                     f"kernel {pk} plain {pp}" for layer, t, pk, pp, first in flips[:12])
           or "none")
        + (f" (and {len(flips) - 12} more)" if len(flips) > 12 else ""))
    in_bad, in_rows = 0, 0
    for layer, ((xk, _, _), (xp, _, _)) in enumerate(zip(rec_k, rec_p)):
        reach = min((t for l, t, _, _, _ in flips if l < layer), default=FORWARD_LEN)
        if reach:
            in_bad += _logit_diff(torch, xk[:reach], xp[:reach], xk.shape[-1])[1]
            in_rows += reach
    first = min((f[1] for f in flips), default=FORWARD_LEN)
    f_worst, bad, f_rel, f_agree = _logit_diff(torch, got[:, :first], want[:, :first],
                                               cfg.vocab_size) if first else (0, 0, 0, 1)
    a_worst, _, a_rel, a_agree = _logit_diff(torch, got, want, cfg.vocab_size)
    log(f"[16 olmoe] float32 forward over (1, {FORWARD_LEN}), kernel vs plain route: MoE "
        f"layer inputs, {in_rows} rows no earlier flip reaches: {in_bad} entries outside "
        f"rtol/atol {PARITY_TOL[0]}/{PARITY_TOL[1]}; logits, the {first} rows before the first "
        f"flipped token: max abs diff {f_worst:.3e}, {bad} entries outside, relative L2 "
        f"{f_rel:.3e}, argmax agrees {f_agree:.4%}; all {FORWARD_LEN} rows: max abs "
        f"{a_worst:.3e}, relative L2 {a_rel:.3e}, argmax agrees {a_agree:.4%}; card: {card}")
    del routes, got, want, params32, rec_k, rec_p
    torch.cuda.empty_cache()
    need(not wide, f"olmoe float32 forward: {len(wide)} primary routing flips with a gap "
         f"between the k-th and (k+1)-th probabilities above {FLIP_GAP}, more than float32 "
         f"rounding explains: {wide[:3]}")
    need(in_bad == 0, f"olmoe float32 forward: {in_bad} MoE-input entries outside tolerance "
         "in the rows no routing flip reaches")
    need(bad == 0, f"olmoe float32 forward: {bad} logits outside tolerance in the rows no "
         "routing flip reaches")
    return serve_launches, fwd_launches


# ------------------------------------------------------------------ phase 17
TWINS = ("torch_detect_from_trace", "torch_quickstart", "torch_serve_decode",
         "torch_train_100m_falcon")
TWIN_CKPT = ROOT / "build" / "chip_smoke_twins"


def _load_twin(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_twin_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin_replay(torch, mod, steps):
    """The train twin's simulator, injector and control plane on the CPU,
    the trainer's model step replaced by one that returns its inputs: the
    timeline and the event log without the model."""
    from repro_torch.configs.base import get_config
    from repro_torch.controlplane import event_log_records
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import FalconTrainer

    sim = mod.make_simulator("cpu")
    trainer = FalconTrainer(
        cfg=get_config("falcon-demo-100m").smoke(),
        data=DataConfig(seq_len=64, global_batch=8, slots=2, dp_groups=4),
        opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=20), perf_model=sim,
        injector=mod.make_injector(sim.healthy_iteration_time()), falcon_enabled=True,
        ckpt_dir=str(TWIN_CKPT), device="cpu")
    trainer._step_fn = lambda p, o, b: (p, o, {"loss": torch.zeros(())})
    hist = trainer.run(steps)
    return (event_log_records(trainer.control.events),
            [(r.step, r.strategy) for r in hist if r.strategy])


def phase_examples(torch, np, card, dev="cuda"):
    """The four example twins on the card through their ``main``, each
    with its reference's asserts; the train twin at falcon-demo-100m's
    published width for 200 steps, its timeline and event log held to a
    CPU replay of the same simulator, injector and control plane, with
    ``cell_reduce`` launched. The twins follow their references, so no
    other kernel is on these paths: the trainers' per-job detector is the
    host's scalar BOCD (no ``bocd_step``), the detect twin is host work,
    the serve twin decodes on the plain route (no ``flash_decode``) and the
    quickstart's (tp 1) simulator needs no reduction kernel. Launches are
    zeroed just before each twin and read just after. Returns them by
    twin."""
    import contextlib
    import io

    from repro_torch.controlplane import event_log_records

    out = {}
    on_card = torch.device(dev).type == "cuda"   # the plain versions launch nothing
    for name in TWINS:
        mod = _load_twin(name)
        argv = ["--device", dev]      # the detect twin, host work, takes no options
        if name == "torch_train_100m_falcon":
            argv += ["--ckpt-dir", str(TWIN_CKPT)]
        buf = io.StringIO()
        _sync(torch, dev)
        read = _zero_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                res = mod.main() if name == "torch_detect_from_trace" else mod.main(argv)
        except AssertionError as exc:
            raise SmokeError(f"{name}: its reference's assert failed: {exc}") from exc
        _sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read()
        lines = buf.getvalue().splitlines()
        need(lines and lines[-1].endswith(" OK"), f"{name} did not end with OK: {lines[-3:]}")
        for line in lines:
            if line.strip():
                log(f"[17 {name}] {line}")
        log(f"[17 {name}] {secs:.2f} s on {dev}; launches {launches}; card: {card}")
        if name == "torch_train_100m_falcon":
            need(res.params["embed"]["tok"].device.type == torch.device(dev).type,
                 f"the twin's parameters are not on {dev}")
            need(not on_card or launches["cell_reduce"] > 0,
                 f"train twin: cell_reduce not launched: {launches}")
            want_log, want_plan = _twin_replay(torch, mod, len(res.history))
            got_log = event_log_records(res.control.events)
            got_plan = [(r.step, r.strategy) for r in res.history if r.strategy]
            need(got_plan == want_plan, f"train twin timeline {got_plan}, CPU replay {want_plan}")
            need(json.dumps(got_log, sort_keys=True) == json.dumps(want_log, sort_keys=True),
                 "train twin: the event log differs from the CPU replay")
            secs_step = res.step_seconds
            log(f"[17 train] timeline {got_plan} and {len(got_log)} event-log records equal "
                f"the CPU replay; {len(secs_step)} steps, median {statistics.median(secs_step[1:]):.4f} "
                f"s a step (host clock, synchronised); card: {card}")
        out[name] = launches
    return out


# ------------------------------------------------------------------ phase 18
# The mesh on the one card: MESH_WORLD ranks (spawned processes) joined by a
# gloo process group on CUDA tensors (NCCL refuses two ranks on one device;
# gloo stages each collective through the host). Sizes: "full" for this
# script, "smoke" for tests/test_torch_card.py.
MESH_WORLD = 4
MESH_PERM = [2, 0, 3, 1]
MESH_COUNTS = [4, 2]
#: AdamW with eps 1: at step 1 the update is linear in the gradient, so a
#: gradient within rounding of 0 cannot move a parameter by +-lr (Adam's
#: sign-like first step) on the all-reduce order alone; no weight decay, so
#: the whole change of a parameter comes from its gradient
MESH_OPT = dict(lr=1e-2, eps=1.0, warmup_steps=0, weight_decay=0.0)
#: (D) holds each leaf's change (the step's parameters less the start) to
#: the one-process step's change, relative to the latter's norm
MESH_STEP_RTOL = 1e-3
#: (G) first forgives each element this many float32 units of its parameter:
#: the model-sharded sums round the gradients otherwise than one process,
#: and a parameter of 1.0 moved by 1e-5 then rounds to the other neighbour
STEP_ULPS = 2
MESH_SIZES = {
    # granite-3-8b at published width and depth: B 8, cache 1,088 slots,
    # decode from position 1,024; olmoe-1b-7b's MoE layer on 4 x 256 tokens
    "full": dict(smoke=False, b=8, prompt=1024, steps=8, slots=1088, moe_tokens=(4, 256),
                 seq20=64),
    "smoke": dict(smoke=True, b=4, prompt=24, steps=2, slots=32, moe_tokens=(4, 16), seq20=64),
}
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "barrier")


def _mesh_cfg(name, size, **kw):
    from dataclasses import replace

    from repro_torch.configs.base import get_config

    cfg = get_config(name)
    if MESH_SIZES[size]["smoke"]:
        cfg = cfg.smoke()
    return replace(cfg, dtype="float32", **kw)


def _seeded(torch, shape, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


def _mesh_caches(torch, cfg, b, s, dev):
    """Full float32 cache leaves from fixed seeds, one at a time:
    ``(sub-layer key, leaf name, tensor)``."""
    from repro_torch.models import transformer

    for i, (key, leaves) in enumerate(sorted(transformer.cache_shapes(cfg, b, s).items())):
        for j, (n, (shape, _)) in enumerate(sorted(leaves.items())):
            yield key, n, _seeded(torch, shape, 100 + 10 * i + j, dev)


def _cache_tree(triples):
    out: dict = {}
    for key, n, t in triples:
        out.setdefault(key, {})[n] = t
    return out


def _mesh_tokens(np, cfg, size):
    sz = MESH_SIZES[size]
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (sz["steps"], sz["b"], 1))


def _mesh_prompt(np, cfg, size):
    sz = MESH_SIZES[size]
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (sz["b"], sz["prompt"]))


def _mesh_reference(size, dev, path):
    """The unsharded float32 prefill and decode of the granite-3-8b check,
    in its own process (freed before the ranks start): the plain prefill's
    logits and cache leaves, and its host seconds, beside ``path`` (.npy);
    then from its caches, grown to the cache length, the plain decode
    route's logits of each step to ``path``; then from the same caches the
    kernel route's, and the host seconds of each of its steps."""
    import numpy as np
    import torch

    from repro_torch.models import model as model_lib, transformer
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    sz = MESH_SIZES[size]
    cfg = _mesh_cfg("granite-3-8b", size)
    params = model_lib.init_params(cfg, 0, device=dev)     # float32 draws cast to bf16
    params = _to_f32(params)                                 # upcast exactly
    _free(torch, dev)
    prompt = torch.as_tensor(_mesh_prompt(np, cfg, size), device=dev)
    with torch.no_grad():
        _sync(torch, dev)
        t0 = time.perf_counter()
        logits, prefilled = make_prefill_step(cfg, sz["prompt"])(params, {"tokens": prompt})
        _sync(torch, dev)
        secs = time.perf_counter() - t0
    base = str(path).replace(".npy", "")
    np.save(f"{base}_prefill.npy", logits.float().cpu().numpy())
    np.save(f"{base}_prefill_secs.npy", np.asarray([secs]))
    for key, leaves in prefilled.items():
        for n, t in leaves.items():
            np.save(f"{base}_cache_{key}_{n}.npy", t.float().cpu().numpy())
    _free(torch, dev)
    toks = _mesh_tokens(np, cfg, size)
    for use_kernel, name in ((False, ""), (True, "_kernel")):
        caches = transformer.grow_caches(prefilled, cfg, sz["slots"])
        step = make_decode_step(cfg, sz["slots"], use_kernel=use_kernel)
        logits, secs = [], []
        with torch.no_grad():
            for i in range(sz["steps"]):
                _sync(torch, dev)
                t0 = time.perf_counter()
                out, caches = step(params, torch.as_tensor(toks[i], device=dev), caches,
                                   sz["prompt"] + i)
                _sync(torch, dev)
                secs.append(time.perf_counter() - t0)
                logits.append(out.float().cpu().numpy())
        del caches
        _free(torch, dev)
        np.save(str(path).replace(".npy", f"{name}.npy"), np.stack(logits))
        np.save(str(path).replace(".npy", f"{name}_secs.npy"), np.asarray(secs))


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _free(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _init_shards(torch, cfg, seed, mesh, dev):
    """This rank's float32 shards of ``init_params(cfg, seed)`` as DTensors
    placed by ``param_specs``: each leaf drawn whole from its own generator
    (the values ``init_params`` gives), sliced, and freed."""
    from repro_torch.models.model import model_schema
    from repro_torch.models.schema import _stable_hash, init_leaf
    from repro_torch.sharding import partition as part
    from repro_torch.sharding.manual import as_dtensor

    sizes, coord = part.axis_sizes(mesh), part.coordinate(mesh)

    def walk(schema, specs, path):
        out = {}
        for name, sub in sorted(schema.items()):
            p = f"{path}/{name}"
            if isinstance(sub, dict):
                out[name] = walk(sub, specs[name], p)
                continue
            gen = torch.Generator(device=dev)
            gen.manual_seed((seed << 31) | _stable_hash(p))
            full = init_leaf(sub, gen, dev)
            local = full[part.shard_slices(full.shape, specs[name], sizes, coord)].float()
            out[name] = as_dtensor(local.contiguous(), specs[name], mesh, shape=full.shape)
            del full, local
            _free(torch, dev)      # the next rank's whole leaves need the room
        return out

    return walk(model_schema(cfg), part.param_specs(cfg, mesh), "")


def _mesh_rank(rank, world, init, workdir, size, dev):
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        if torch.device(dev).type == "cuda":
            torch.cuda.set_device(0)
        torch.set_num_threads(2)          # four ranks share the host's cores
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        try:
            res = _mesh_checks(torch, rank, world, size, dev, workdir)
        finally:
            dist.destroy_process_group()
        with open(Path(workdir) / f"rank{rank}.json", "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(Path(workdir) / f"error{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise


def _diff(torch, got, want, vocab=None):
    """(max abs difference, entries outside PARITY_TOL) of two tensors."""
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    g, w = got.double(), want.double()
    if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
        return float("inf"), -1
    d = (g - w).abs()
    rtol, atol = PARITY_TOL
    return float(d.max()), int((d > atol + rtol * w.abs()).sum())


def _mesh_checks(torch, rank, world, size, dev, workdir):
    import numpy as np
    import torch.distributed as dist

    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib, moe
    from repro_torch.models.schema import init_tree
    from repro_torch.optim import adamw
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    from repro_torch.serve.sharded_prefill import grow_caches
    from repro_torch.sharding import set_mesh
    from repro_torch.sharding import partition as part
    from repro_torch.sharding.manual import gather
    from repro_torch.train.train_step import make_adaptive_train_step, make_train_step
    from repro_torch.train.trainer import remap_mesh

    sz = MESH_SIZES[size]
    res = {}

    # Which collectives gloo serves for this device's tensors.
    probe = {}
    for op in COLLECTIVES:
        t = torch.ones(8, device=dev)
        try:
            if op == "all_reduce":
                dist.all_reduce(t)
            elif op == "broadcast":
                dist.broadcast(t, 0)
            elif op == "all_gather":
                dist.all_gather([torch.empty_like(t) for _ in range(world)], t)
            elif op == "all_gather_into_tensor":
                dist.all_gather_into_tensor(torch.empty(8 * world, device=dev), t)
            elif op == "reduce_scatter_tensor":
                dist.reduce_scatter_tensor(torch.empty(2, device=dev), t)
            elif op == "all_to_all_single":
                dist.all_to_all_single(torch.empty_like(t), t)
            else:
                dist.barrier()
            _sync(torch, dev)
            probe[op] = "served"
        except (RuntimeError, ValueError, NotImplementedError) as exc:
            probe[op] = f"refused: {str(exc).splitlines()[0][:100]}"
    res["collectives"] = probe
    dist.barrier()

    # (F) granite-3-8b over (data 1, model 4): the sharded prefill of the
    # prompt, held to the unsharded plain prefill (logits and every cache
    # leaf, each rank its own shards).
    cfg = _mesh_cfg("granite-3-8b", size)
    mesh = make_host_mesh(1, world, device=dev)
    s_total = sz["slots"]
    sizes, coord = part.axis_sizes(mesh), part.coordinate(mesh)
    for turn in range(world):      # one rank draws its whole leaves at a time
        if turn == rank:
            params = _init_shards(torch, cfg, 0, mesh, dev)
        dist.barrier()
    prompt = torch.as_tensor(_mesh_prompt(np, cfg, size), device=dev)
    with set_mesh(mesh), torch.no_grad():
        _sync(torch, dev)
        t0 = time.perf_counter()
        logits, caches = make_prefill_step(cfg, sz["prompt"])(params, {"tokens": prompt})
        _sync(torch, dev)
        prefill_secs = time.perf_counter() - t0
        full_logits = gather(logits.to_local(), part.spec_of(logits), mesh)
    base = str(Path(workdir) / "reference")
    err, bad = _diff(torch, full_logits.float(),
                     torch.as_tensor(np.load(f"{base}_prefill.npy"), device=dev), cfg.vocab_size)
    cerr, cbad, leaves = 0.0, 0, 0
    for key, c in caches.items():
        for n, t in c.items():
            want = np.load(f"{base}_cache_{key}_{n}.npy", mmap_mode="r")
            mine = want[part.shard_slices(want.shape, part.spec_of(t), sizes, coord)]
            e, k = _diff(torch, t.to_local().float(), torch.as_tensor(np.ascontiguousarray(mine),
                                                                      device=dev))
            cerr, cbad, leaves = max(cerr, e), cbad + k, leaves + 1
    res["prefill"] = {"max_err": err, "bad": bad, "cache_err": cerr, "cache_bad": cbad,
                      "cache_leaves": leaves, "secs": prefill_secs,
                      "cache_spec": str(part.spec_of(caches["sub0"]["k"])),
                      "ref_secs": float(np.load(f"{base}_prefill_secs.npy")[0])}
    del logits, full_logits
    _free(torch, dev)

    # (A) decode from (F)'s caches, grown to the cache length: KV heads
    # sharded, the kernel route.
    with torch.no_grad():
        caches = grow_caches(caches, cfg, s_total, mesh)
    step = make_decode_step(cfg, s_total, use_kernel=True)
    toks = _mesh_tokens(np, cfg, size)
    tspec = part.decode_token_specs(cfg, mesh, sz["b"])
    gloo_s = [0.0]
    real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather_into_tensor",
                                                   "reduce_scatter_tensor")}

    def timed(fn):
        def call(*a, **k):
            _sync(torch, dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _sync(torch, dev)
            gloo_s[0] += time.perf_counter() - t0
            return out
        return call

    local_logits, secs = [], []
    with set_mesh(mesh), torch.no_grad():
        for name, fn in real.items():
            setattr(dist, name, timed(fn))
        try:
            fd.launches = 0
            for i in range(sz["steps"]):
                tok = part.distribute(torch.as_tensor(toks[i], device=dev), tspec, mesh)
                _sync(torch, dev)
                t0 = time.perf_counter()
                logits, caches = step(params, tok, caches, sz["prompt"] + i)
                _sync(torch, dev)
                secs.append(time.perf_counter() - t0)
                local_logits.append(logits.to_local().clone())
            launches = fd.launches
        finally:
            for name, fn in real.items():
                setattr(dist, name, fn)
        lspec = part.spec_of(logits)
        full_logits = [gather(t, lspec, mesh) for t in local_logits]
    res["decode"] = {"launches": launches, "secs": secs, "gloo_s": gloo_s[0],
                     "layers": cfg.num_layers,
                     "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                  if torch.device(dev).type == "cuda" else 0.0)}
    if rank == 0:
        want = torch.as_tensor(np.load(Path(workdir) / "reference.npy"), device=dev)
        diffs = [_diff(torch, got.float(), want[i], cfg.vocab_size)
                 for i, got in enumerate(full_logits)]
        # The unsharded kernel route against the plain one, for the log.
        kern = torch.as_tensor(np.load(Path(workdir) / "reference_kernel.npy"), device=dev)
        kdiffs = [_diff(torch, kern[i], want[i], cfg.vocab_size) for i in range(len(kern))]
        res["decode"].update(
            max_err=max(d[0] for d in diffs), bad=sum(d[1] for d in diffs),
            unsharded_kernel_err=max(d[0] for d in kdiffs),
            ref_secs=np.load(Path(workdir) / "reference_kernel_secs.npy").tolist(),
            plain_secs=np.load(Path(workdir) / "reference_secs.npy").tolist())
    del params, caches, local_logits, full_logits
    _free(torch, dev)
    dist.barrier()

    # (B) the sequence-sharded cache on kv = 1 (granite-20b smoke) over (2, 2).
    mesh = make_host_mesh(2, world // 2, device=dev)
    cfg = _mesh_cfg("granite-20b", "smoke")
    params = {k: v for k, v in model_lib.init_params(cfg, 0, device=dev).items()}
    params = _to_f32(params)
    seq = sz["seq20"]
    caches0 = _cache_tree(_mesh_caches(torch, cfg, 4, seq, dev))
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 4, 1))
    out_b = []
    for b, kern in ((4, False), (4, True), (1, False), (1, True)):
        full = {k: {n: t[:, :b].clone() for n, t in c.items()} for k, c in caches0.items()}
        ref = {k: {n: t.clone() for n, t in c.items()} for k, c in full.items()}
        dist_c = part.distribute(full, part.cache_specs(cfg, mesh, b), mesh)
        dist_p = part.distribute(params, part.param_specs(cfg, mesh), mesh)
        step = make_decode_step(cfg, seq, use_kernel=kern)
        plain = make_decode_step(cfg, seq)     # the unsharded plain route
        err, bad = 0.0, 0
        with torch.no_grad():
            fd.launches = 0
            for i, pos in enumerate((seq - 21, seq - 20)):
                tok = torch.as_tensor(toks[i, :b], device=dev)
                with set_mesh(mesh):
                    lg, dist_c = step(dist_p, part.distribute(tok, part.decode_token_specs(
                        cfg, mesh, b), mesh), dist_c, pos)
                    lg = gather(lg.to_local(), part.spec_of(lg), mesh)
                want, ref = plain(params, tok, ref, pos)
                e, k = _diff(torch, lg, want, cfg.vocab_size)
                err, bad = max(err, e), bad + k
            launches_b = fd.launches
            for key, c in dist_c.items():
                for n, t in c.items():
                    e, k = _diff(torch, gather(t.to_local(), part.spec_of(t), mesh), ref[key][n])
                    err, bad = max(err, e), bad + k
        out_b.append({"b": b, "kernel": kern, "max_err": err, "bad": bad,
                      "launches": launches_b,
                      "cache_spec": str(part.cache_specs(cfg, mesh, b)["sub0"]["k"])})
    res["seq_shard"] = out_b
    del params, caches0
    dist.barrier()

    # (C) one olmoe-1b-7b MoE layer over (2, 2), capacity factor 8 (no drops).
    cfg = _mesh_cfg("olmoe-1b-7b", size, capacity_factor=8.0)
    params = _to_f32(init_tree(moe.moe_schema(cfg), 0, dev))
    nb, ns = sz["moe_tokens"]
    x = _seeded(torch, (nb, ns, cfg.d_model), 5, dev)
    with torch.no_grad():
        y_ref, _ = moe.apply_moe(params, x, cfg)
        # The EP aux loss is the mean of each data shard's own (the
        # reference's pmean over the batch axes), not the whole batch's.
        half = nb // 2
        aux_ref = sum(moe.apply_moe(params, x[d * half:(d + 1) * half], cfg)[1]
                      for d in range(2)) / 2
        with set_mesh(mesh):
            y, aux = moe.apply_moe(params, x, cfg)
    e, k = _diff(torch, y, y_ref)
    ea, ka = _diff(torch, aux.reshape(1), aux_ref.reshape(1))
    res["moe"] = {"max_err": e, "bad": k, "aux_err": ea, "aux_bad": ka,
                  "tokens": nb * ns, "experts": cfg.num_experts, "e_local": cfg.padded_experts // 2}
    del params, x, y, y_ref
    dist.barrier()

    # (D) one adaptive step of falcon-demo-100m over (2, 2), counts [4, 2].
    from repro_torch.data.pipeline import DataConfig, make_batch

    cfg = _mesh_cfg("falcon-demo-100m", size)
    opt = adamw.AdamWConfig(**MESH_OPT)
    data = DataConfig(seq_len=64, global_batch=8, slots=4, dp_groups=2)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(cfg, data, 0).items()}
    params = _to_f32(model_lib.init_params(cfg, 0, device=dev))
    p2, _, m = make_adaptive_train_step(cfg, opt, mesh)(params, adamw.init(params), batch,
                                                        MESH_COUNTS)
    res["adaptive"] = {"loss": float(m["loss"])}
    if rank == 0:
        start = dict(adamw.leaves(_to_f32(model_lib.init_params(cfg, 0, device=dev))))
        one, one_loss = _one_process_step(torch, cfg, opt, batch, MESH_COUNTS, dev)
        # The control: the step at counts [1, 1] must fail the same check.
        control, _ = _one_process_step(torch, cfg, opt, batch, [1] * len(MESH_COUNTS), dev)
        got = {path: t.detach() for path, t in adamw.leaves(p2)}
        err, bad = 0.0, 0
        for path, t in got.items():
            e, k = _diff(torch, t, one[path])
            err, bad = max(err, e), bad + k
        res["adaptive"].update(
            max_err=err, bad=bad, leaves=len(one), one_loss=one_loss,
            moved=sum(int(not torch.equal(t, start[path])) for path, t in got.items()),
            step_err=_step_err(got, one, start), control_err=_step_err(control, one, start))
    del params, p2, batch
    dist.barrier()

    # (G) one even train step of falcon-demo-100m over (2, 2), model-sharded:
    # DTensor parameters and ZeRO-1 moments, make_train_step under the mesh.
    from repro_torch.models.model import param_shapes
    from repro_torch.sharding import P

    cfg = _mesh_cfg("falcon-demo-100m", size)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(cfg, data, 0).items()}
    params = _to_f32(model_lib.init_params(cfg, 0, device=dev))
    specs = part.param_specs(cfg, mesh)
    opt0 = adamw.init(params)
    ospecs = adamw.opt_state_specs(specs, param_shapes(cfg), mesh)
    o_d = adamw.AdamWState(step=part.distribute(opt0.step, P(), mesh),
                           mu=part.distribute(opt0.mu, ospecs.mu, mesh),
                           nu=part.distribute(opt0.nu, ospecs.nu, mesh))
    p_d = part.distribute(params, specs, mesh)
    del opt0, params
    with set_mesh(mesh):
        p2, _, m = make_train_step(cfg, opt)(p_d, o_d, batch)
    got = {path: gather(t.to_local(), part.spec_of(t), mesh)
           for path, t in adamw.leaves(p2)}
    res["even"] = {"loss": float(m["loss"]),
                   "sharded": sum(int(any(e is not None for e in part.spec_of(t)))
                                  for _, t in adamw.leaves(p2))}
    if rank == 0:
        start = dict(adamw.leaves(_to_f32(model_lib.init_params(cfg, 0, device=dev))))
        one, one_loss = _one_process_even_step(torch, cfg, opt, batch, dev)
        # The control: the step on the first slot alone must fail the same check.
        control, _ = _one_process_even_step(torch, cfg, opt,
                                            {k: v[:1] for k, v in batch.items()}, dev)
        err, bad = 0.0, 0
        for path, t in got.items():
            e, k = _diff(torch, t, one[path])
            err, bad = max(err, e), bad + k
        res["even"].update(
            max_err=err, bad=bad, leaves=len(one), one_loss=one_loss,
            moved=sum(int(not torch.equal(t, start[path])) for path, t in got.items()),
            step_err=_step_err(got, one, start, STEP_ULPS),
            control_err=_step_err(control, one, start, STEP_ULPS))
    del p_d, o_d, p2, got, batch
    _free(torch, dev)
    dist.barrier()

    # (H) the gradient of one olmoe-1b-7b MoE layer through the
    # expert-parallel path over (2, 2) (capacity factor 8), against the
    # local dispatch's on each data shard's tokens.
    from repro_torch.models import sharded as sh
    from repro_torch.sharding.manual import all_reduce, local_shard

    cfg = _mesh_cfg("olmoe-1b-7b", size, capacity_factor=8.0)
    params = _to_f32(init_tree(moe.moe_schema(cfg), 0, dev))
    x = _seeded(torch, (nb, ns, cfg.d_model), 5, dev)
    w = _seeded(torch, (nb, ns, cfg.d_model), 6, dev)
    wspec, xspec = moe.ep_specs(cfg, ("data",))
    local = {k: local_shard(params[k], wspec[k], mesh).detach().requires_grad_(True)
             for k in wspec}
    xl = local_shard(x, xspec, mesh).detach().requires_grad_(True)
    y, aux = sh.moe(local, wspec, xl, ("data",), cfg, mesh)
    loss = (y.float() * local_shard(w, xspec, mesh)).sum() + aux
    grads = torch.autograd.grad(loss, [*local.values(), xl])
    got = {k: gather(all_reduce(g, "data", mesh), P(*[e if e == "model" else None
                                                      for e in wspec[k]]), mesh)
           for k, g in zip(local, grads)}
    got["x"] = gather(grads[-1], xspec, mesh)
    res["moe_grad"] = {"leaves": len(got)}
    if rank == 0:
        ref = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        xr = x.detach().requires_grad_(True)
        half = nb // 2
        total = 0.0
        for d in range(2):
            yd, ad = moe.apply_moe(ref, xr[d * half:(d + 1) * half], cfg)
            total = total + (yd.float() * w[d * half:(d + 1) * half]).sum() + ad
        want = dict(zip([*ref, "x"], torch.autograd.grad(total, [*ref.values(), xr])))
        rel = {k: float((got[k].double() - want[k].double()).norm()
                        / want[k].double().norm().clamp_min(1e-300)) for k in got}
        res["moe_grad"].update(rel=rel, worst=max(rel.values()),
                               max_err=max(_diff(torch, got[k], want[k])[0] for k in got))
    del params, x, w, local, xl, y, grads, got
    _free(torch, dev)
    dist.barrier()

    # (E) remap_mesh with a permutation.
    new = remap_mesh(mesh, MESH_PERM)
    res["remap"] = {"coord": list(mesh.get_coordinate()), "new": list(new.get_coordinate()),
                    "ranks": new.mesh.tolist()}
    return res


def _to_f32(tree):
    """``tree``'s leaves upcast to float32 in place, one at a time (each
    bf16 leaf is freed as its copy is made), and ``tree``."""
    for k, v in tree.items():
        tree[k] = _to_f32(v) if isinstance(v, dict) else v.float()
    return tree


def _step_err(got, want, start, ulps=0):
    """The largest, over leaves, of |(got - start) - (want - start)| /
    |want - start| (Frobenius norms, float64): how far a step's change of
    the parameters is from the wanted change. With ``ulps``, each element's
    difference is first reduced by that many float32 units in the last
    place of the parameter: a change of ~1e-5 to a norm weight of 1.0 is
    ~100 units, so one unit of rounding either way would read 1e-2."""
    worst = 0.0
    for path, w in want.items():
        dw = w.double() - start[path].double()
        dg = got[path].double() - start[path].double()
        gap = (dg - dw).abs()
        if ulps:
            unit = 2.0 ** -23 * w.double().abs().clamp_min(start[path].double().abs())
            gap = (gap - ulps * unit).clamp_min(0.0)
        worst = max(worst, float(gap.norm() / dw.norm().clamp_min(1e-300)))
    return worst


def _one_process_even_step(torch, cfg, opt, batch, dev):
    """The unsharded even step (``make_train_step``, no mesh) from the
    float32 initial parameters: (parameters, loss)."""
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    params = _to_f32(model_lib.init_params(cfg, 0, device=dev))
    params, _, m = make_train_step(cfg, opt)(params, adamw.init(params), batch)
    return {k: v.detach() for k, v in adamw.leaves(params)}, float(m["loss"])


def _one_process_step(torch, cfg, opt, batch, counts, dev):
    """The weighted-gradient step in one process: group g's first counts[g]
    slots of its columns, the gradients summed, divided by sum(counts)."""
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import _unflatten

    params = _to_f32(model_lib.init_params(cfg, 0, device=dev))
    paths, flat = zip(*adamw.leaves(params))
    for p in flat:
        p.requires_grad_(True)
    gsum = [torch.zeros_like(p) for p in flat]
    cols = batch["tokens"].shape[1] // len(counts)
    total = 0.0
    for g, m in enumerate(counts):
        for i in range(m):
            mb = {k: v[i, g * cols:(g + 1) * cols] for k, v in batch.items()}
            loss, _ = model_lib.loss_fn(params, mb, cfg)
            for acc, gr in zip(gsum, torch.autograd.grad(loss, flat)):
                acc.add_(gr)
            total += float(loss.detach())
    grads = _unflatten(paths, [g / sum(counts) for g in gsum])
    params, _ = adamw.update(opt, grads, adamw.init(params), params)
    return {k: v.detach() for k, v in adamw.leaves(params)}, total / sum(counts)


def _run_procs(target, args_list, timeout, what):
    """Start one spawned process per argument tuple, join them under one
    deadline; a process still running then is terminated and fails."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_list]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    need(not hung, f"{what}: processes {hung} still running after {timeout} s")
    return [p.exitcode for p in procs]


def phase_mesh(torch, np, card, size="full", dev="cuda", timeout=900):
    """The mesh on the one card (MESH_WORLD spawned ranks, gloo): the
    collectives gloo serves for the card's tensors; (A) granite-3-8b over
    (data 1, model 4) with the kernel route, logits held to the unsharded
    plain route (computed first in a child process and freed),
    ``flash_decode`` launched once per layer and step on every rank; (B)
    granite-20b smoke (kv 1) with the cache sequence sharded over model,
    and folded over (data, model) at batch 1, both routes, held to the
    unsharded plain route; (C) one olmoe-1b-7b MoE layer, expert-parallel,
    held to the local dispatch; (D) one adaptive step of falcon-demo-100m
    with counts [4, 2], held to the one-process weighted step, each leaf's
    change within MESH_STEP_RTOL of the one-process change, which the step
    at counts [1, 1] must miss; (E) ``remap_mesh``. All in float32 to
    PARITY_TOL. Returns rank 0's results and every rank's (A) launches."""
    import shutil

    workdir = ROOT / "build" / "chip_smoke_mesh" / size
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    t0 = time.perf_counter()
    codes = _run_procs(_mesh_reference, [(size, dev, str(workdir / "reference.npy"))],
                       timeout, "the unsharded reference")
    need(codes == [0], f"the unsharded reference process exited with {codes}")
    init = f"file://{workdir / 'rendezvous'}"
    codes = _run_procs(_mesh_rank, [(r, MESH_WORLD, init, str(workdir), size, dev)
                                    for r in range(MESH_WORLD)], timeout, "the mesh ranks")
    errors = [(workdir / f"error{r}.txt").read_text() for r in range(MESH_WORLD)
              if (workdir / f"error{r}.txt").exists()]
    need(not errors, "a mesh rank failed:\n" + "\n".join(e[-2500:] for e in errors[:2]))
    need(codes == [0] * MESH_WORLD, f"mesh ranks exited with {codes}")
    ranks = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(MESH_WORLD)]
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    sz = MESH_SIZES[size]
    log(f"[18 mesh] {MESH_WORLD} ranks on one {dev} device, gloo; collectives on "
        f"{dev} tensors: {r0['collectives']}; card: {card}")
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        need(r0["collectives"][name] == "served", f"gloo did not serve {name}: {r0['collectives']}")

    pre = r0["prefill"]
    for r, rk in enumerate(ranks):
        f = rk["prefill"]
        need(f["cache_bad"] == 0, f"(F) rank {r}: {f['cache_bad']} cache values outside "
             f"PARITY_TOL (max abs difference {f['cache_err']:.3e})")
    need(pre["bad"] == 0, f"(F) {pre['bad']} sharded prefill logits outside PARITY_TOL "
         f"(max abs difference {pre['max_err']:.3e})")
    log(f"[18 mesh] (F) granite-3-8b{' smoke' if sz['smoke'] else ' published width and depth'}"
        f" float32 over (data 1, model {MESH_WORLD}): sharded prefill of {sz['b']} x "
        f"{sz['prompt']} tokens, last-token logits equal the unsharded plain prefill's (max abs "
        f"difference {pre['max_err']:.3e}), {pre['cache_leaves']} cache leaves a rank, caches "
        f"placed {pre['cache_spec']} (max abs difference over ranks "
        f"{max(r['prefill']['cache_err'] for r in ranks):.3e}); none outside PARITY_TOL; "
        f"{pre['secs']:.2f} s sharded against {pre['ref_secs']:.2f} s unsharded (host clock, "
        f"synchronised); card: {card}")

    dec = r0["decode"]
    launches = [r["decode"]["launches"] for r in ranks]
    on_card = torch.device(dev).type == "cuda"   # the plain versions launch nothing
    need(all(n == dec["layers"] * sz["steps"] * on_card for n in launches),
         f"(A) flash_decode launches per rank {launches}, expected {dec['layers']} x {sz['steps']}")
    need(dec["bad"] == 0, f"(A) {dec['bad']} sharded decode logits outside PARITY_TOL "
         f"(max abs difference {dec['max_err']:.3e})")
    ms = statistics.median(dec["secs"]) * 1e3
    ref_ms = statistics.median(dec["ref_secs"]) * 1e3
    plain_ms = statistics.median(dec["plain_secs"]) * 1e3
    log(f"[18 mesh] (A) granite-3-8b{' smoke' if sz['smoke'] else ' published width and depth'}"
        f" float32 over (data 1, model {MESH_WORLD}), B {sz['b']}, (F)'s caches grown to "
        f"{sz['slots']} slots, {sz['steps']} decode steps from {sz['prompt']}, kernel route: "
        f"logits equal the "
        f"unsharded plain route's (max abs difference {dec['max_err']:.3e}, none outside "
        f"PARITY_TOL; the unsharded kernel route's {dec['unsharded_kernel_err']:.3e}); "
        f"flash_decode launches per rank {launches}")
    log(f"[18 mesh] (A) decode {ms:.2f} ms a step sharded (median, host clock, synchronised; "
        f"collectives timed with a synchronise around each) against {ref_ms:.2f} ms unsharded "
        f"(kernel route; plain route {plain_ms:.2f} ms); "
        f"gloo share {dec['gloo_s'] / sum(dec['secs']):.1%} of the sharded steps; peak memory "
        f"per rank {[round(r['decode']['peak_gib'], 2) for r in ranks]} GiB; card: {card}")
    for case in r0["seq_shard"]:
        need(case["bad"] == 0, f"(B) {case}: values outside PARITY_TOL")
        if case["kernel"] and on_card:
            need(case["launches"] > 0, f"(B) {case}: flash_decode not launched")
    log(f"[18 mesh] (B) granite-20b smoke (kv 1) over (data 2, model 2), each route against "
        f"the unsharded plain route: "
        + "; ".join(f"B {c['b']} {'kernel' if c['kernel'] else 'plain'} cache {c['cache_spec']}: "
                    f"max abs difference {c['max_err']:.2e}, launches {c['launches']}"
                    for c in r0["seq_shard"]))
    m = r0["moe"]
    need(m["bad"] == 0 and m["aux_bad"] == 0, f"(C) expert-parallel MoE outside PARITY_TOL: {m}")
    log(f"[18 mesh] (C) olmoe-1b-7b MoE layer{' (smoke)' if sz['smoke'] else ''} over (data 2, "
        f"model 2), capacity factor 8, {m['tokens']} tokens, {m['experts']} experts "
        f"({m['e_local']} a model rank): equal to the local dispatch (max abs difference "
        f"{m['max_err']:.2e}; aux, the mean of the data shards' own, {m['aux_err']:.2e})")
    a = r0["adaptive"]
    need(a["bad"] == 0 and a["moved"] == a["leaves"], f"(D) adaptive step: {a}")
    need(a["step_err"] <= MESH_STEP_RTOL, f"(D) the step's change is {a['step_err']:.3e} "
         f"(relative) off the one-process step's, above {MESH_STEP_RTOL}")
    need(a["control_err"] > MESH_STEP_RTOL, f"(D) the check cannot tell counts [1, 1] from "
         f"{MESH_COUNTS}: {a['control_err']:.3e}")
    need(all(abs(r["adaptive"]["loss"] - a["one_loss"]) <= PARITY_TOL[1] + PARITY_TOL[0]
             * abs(a["one_loss"]) for r in ranks), "(D) adaptive loss differs")
    log(f"[18 mesh] (D) falcon-demo-100m{' smoke' if sz['smoke'] else ''} adaptive step over "
        f"(data 2, model 2), counts {MESH_COUNTS}: {a['leaves']} leaves equal the one-process "
        f"weighted step (max abs difference {a['max_err']:.2e}, {a['moved']} moved); each "
        f"leaf's change within {a['step_err']:.2e} of the one-process change (relative, "
        f"bound {MESH_STEP_RTOL}; the step at counts [1, 1] is {a['control_err']:.2e} off); "
        f"loss {a['loss']:.6f} vs {a['one_loss']:.6f}")
    ev = r0["even"]
    need(ev["bad"] == 0 and ev["moved"] == ev["leaves"], f"(G) even step: {ev}")
    need(ev["sharded"] > 0, f"(G) no parameter was placed over the mesh: {ev}")
    need(ev["step_err"] <= MESH_STEP_RTOL, f"(G) the step's change is {ev['step_err']:.3e} "
         f"(relative) off the one-process step's, above {MESH_STEP_RTOL}")
    need(ev["control_err"] > MESH_STEP_RTOL, f"(G) the check cannot tell the first slot's "
         f"step from the whole one: {ev['control_err']:.3e}")
    need(all(abs(r["even"]["loss"] - ev["one_loss"]) <= PARITY_TOL[1] + PARITY_TOL[0]
             * abs(ev["one_loss"]) for r in ranks), "(G) even-step loss differs")
    log(f"[18 mesh] (G) falcon-demo-100m{' smoke' if sz['smoke'] else ''} even train step over "
        f"(data 2, model 2), {ev['sharded']} of {ev['leaves']} leaves placed over the mesh, "
        f"ZeRO-1 moments: equal to the one-process make_train_step (max abs difference "
        f"{ev['max_err']:.2e}, {ev['moved']} moved); each leaf's change within "
        f"{ev['step_err']:.2e} of the one-process change (relative, {STEP_ULPS} float32 units "
        f"forgiven, bound {MESH_STEP_RTOL}; the "
        f"step on the first slot alone is {ev['control_err']:.2e} off); loss {ev['loss']:.6f} "
        f"vs {ev['one_loss']:.6f}")
    mg = r0["moe_grad"]
    need(mg["worst"] <= MESH_STEP_RTOL, f"(H) expert-parallel gradients off the local "
         f"dispatch's: {mg['rel']}")
    log(f"[18 mesh] (H) olmoe-1b-7b MoE layer{' (smoke)' if sz['smoke'] else ''} over (data 2, "
        f"model 2), capacity factor 8: the gradients of its {mg['leaves'] - 1} weights and of "
        f"its input through the expert-parallel path equal the local dispatch's on each data "
        f"shard (worst relative norm difference {mg['worst']:.2e}, bound {MESH_STEP_RTOL}; max "
        f"abs {mg['max_err']:.2e})")
    new = r0["remap"]["ranks"]
    for rank, r in enumerate(ranks):
        pos = [(i, j) for i, row in enumerate(new) for j, v in enumerate(row) if v == rank][0]
        need(tuple(r["remap"]["new"]) == pos, f"(E) rank {rank} at {r['remap']['new']}, "
             f"expected {pos}")
    log(f"[18 mesh] (E) remap_mesh {MESH_PERM}: ranks at {new}, each rank's coordinate moved "
        f"as the permutation says; phase {secs:.1f} s")
    return {"ranks": ranks, "launches": launches}


# ------------------------------------------------------------------ phase 19
# The dry-run twin on the card (repro_torch.launch.dryrun), in a child
# process: its fake process group of 256 or 512 ranks must not live in this
# one. (arch, shape, multi_pod): granite-3-8b at every shape, mamba2-2.7b and
# olmoe-1b-7b (expert-parallel, with its gradient) training, jamba's prefill
# (FSDP, Mamba2, MoE), and granite-3-8b training over two pods.
DRYRUN_COMBOS = (
    ("granite-3-8b", "train_4k", False), ("granite-3-8b", "prefill_32k", False),
    ("granite-3-8b", "decode_32k", False), ("granite-3-8b", "long_500k", False),
    ("mamba2-2.7b", "train_4k", False), ("olmoe-1b-7b", "train_4k", False),
    ("jamba-1.5-large-398b", "prefill_32k", False), ("granite-3-8b", "train_4k", True),
)
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
#: the step must do at least this share of the analytic model operations
#: per device (2 N_active tokens inference, 6 N_active tokens training, as
#: benchmarks/roofline.py counts them): the matrix products of the model
DRYRUN_FLOPS_SHARE = 0.9
#: seconds after the script's start by which the CPU (FakeTensorMode)
#: estimates, started with phase 19, must be done; the ones still running
#: then are stopped and logged as not finished
DRYRUN_CPU_DEADLINE = 840


def _dryrun_child(combos, out_path):
    """Each combination's card record (or its error) to ``out_path``."""
    import traceback

    from repro_torch.launch import dryrun

    out = []
    for arch, shape, mp in combos:
        try:
            out.append({"ok": True, **dryrun.dryrun(arch, shape, mp, "cuda")})
        except Exception as exc:  # noqa: BLE001  reported by the parent, which fails
            out.append({"ok": False, "arch": arch, "shape": shape, "multi_pod": mp,
                        "error": f"{type(exc).__name__}: {exc}"[:600],
                        "trace": traceback.format_exc()[-2000:]})
        import gc

        import torch

        gc.collect()
        torch.cuda.empty_cache()
    Path(out_path).write_text(json.dumps(out))


def start_dryrun_estimates():
    """The CPU route (``--device cpu``: FakeTensorMode, MemTracker's peak)
    of each phase-19 combination, one process each at the lowest priority
    and on every host core but the first, beside phase 19's card child
    only: they use the host and that child the card, and no phase timed on
    the host's clock runs beside them. The longest (a train step at 0.2-0.5
    ms of host time per eager operation) takes minutes."""
    import os
    import shutil

    cores = sorted(os.sched_getaffinity(0))
    theirs = set(cores[1:]) or set(cores)

    def lowly():
        os.nice(19)
        os.sched_setaffinity(0, theirs)

    cpu_dir = DRYRUN_DIR / "cpu"
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    cpu_dir.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for arch, shape, mp in DRYRUN_COMBOS:
        log_file = open(cpu_dir / f"{arch}__{shape}__{mp}.log", "w")
        procs.append((log_file, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--multi-pod", "on" if mp else "off", "--device", "cpu", "--out",
             str(cpu_dir)], cwd=ROOT, env=env, stdout=log_file, stderr=subprocess.STDOUT,
            preexec_fn=lowly)))
    return procs


def _expected_argument_bytes(arch, shape, multi_pod):
    """Rank 0's argument bytes worked out from the port's partition
    functions on the mesh's axis names and sizes alone (no process group):
    every leaf's shard shape times its item size."""
    import math
    from types import SimpleNamespace

    import torch

    from repro_torch.configs.base import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import param_shapes
    from repro_torch.optim import adamw
    from repro_torch.sharding import P
    from repro_torch.sharding import partition as part

    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = SimpleNamespace(mesh_dim_names=names, shape=(2, 16, 16) if multi_pod else (16, 16))
    sizes, coord = part.axis_sizes(mesh), dict.fromkeys(names, 0)
    cfg = get_config(arch)
    info = INPUT_SHAPES[shape]
    dp = part.mesh_axis_size(mesh, part.batch_axes(mesh))
    pspecs = part.param_specs(cfg, mesh)
    if cfg.total_params() * 2 / sizes["model"] > dryrun.FSDP_SERVE_BYTES:
        pspecs = part.fsdp_param_specs(cfg, mesh)
    shapes = param_shapes(cfg)
    inputs = dryrun.input_specs(cfg, shape, dp)

    def total(tree, specs, dtype=None):
        if isinstance(tree, dict):
            return sum(total(tree[k], specs[k], dtype) for k in tree)
        local = [sl.stop - sl.start for sl in part.shard_slices(tree.shape, specs, sizes, coord)]
        return math.prod(local) * (dtype or tree.dtype).itemsize

    nbytes = total(shapes, pspecs)
    if info["kind"] == "train":
        ospecs = adamw.opt_state_specs(pspecs, shapes, mesh)
        nbytes += 4 + 2 * total(shapes, ospecs.mu, torch.float32)
        return nbytes + total(inputs, part.train_batch_specs(cfg, mesh))
    gb = info["global_batch"]
    if info["kind"] == "prefill":
        return nbytes + total(inputs, part.serve_batch_specs(cfg, mesh, gb))
    return (nbytes + total(inputs["tokens"], part.decode_token_specs(cfg, mesh, gb))
            + total(inputs["caches"], part.cache_specs(cfg, mesh, gb)))


def phase_dryrun(torch, card, t_start):
    """The dry-run of DRYRUN_COMBOS on the card in a child process: each
    record's argument bytes equal to the shard-shape sum worked out here,
    its peak within the card's memory, its operations at least
    DRYRUN_FLOPS_SHARE of the model's per device; the CPU route's
    MemTracker estimate (run beside the card child) logged beside each
    measured peak. Returns the records."""
    from repro_torch.configs.base import INPUT_SHAPES, get_config

    out_path = DRYRUN_DIR / "card.json"
    estimates = start_dryrun_estimates()
    try:
        t0 = time.perf_counter()
        codes = _run_procs(_dryrun_child, [(DRYRUN_COMBOS, str(out_path))], 600,
                           "the dry-run")
        need(codes == [0] and out_path.exists(), f"the dry-run child exited with {codes}")
        secs = time.perf_counter() - t0
        records = json.loads(out_path.read_text())
        failed = [r for r in records if not r["ok"]]
        need(not failed, "dry-run combinations failed on the card: "
             + "; ".join(f"{r['arch']} {r['shape']}: {r['error']}" for r in failed)
             + (f"\n{failed[0]['trace']}" if failed else ""))
        # The CPU estimates: wait for them until the deadline.
        deadline = t_start + DRYRUN_CPU_DEADLINE
        for _, proc in estimates:
            try:
                proc.wait(timeout=max(0.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for log_file, proc in estimates:     # the rest are stopped
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()
    cap = torch.cuda.get_device_properties(0).total_memory
    log(f"[19 dryrun] {len(records)} combinations on the card in {secs:.1f} s (one child "
        f"process, rank 0 of a fake process group); card: {card}")
    for (arch, shape, mp), rec in zip(DRYRUN_COMBOS, records):
        bpd = rec["bytes_per_device"]
        want = _expected_argument_bytes(arch, shape, mp)
        need(bpd["argument"] == want, f"(19) {arch} {shape} {rec['mesh']}: argument bytes "
             f"{bpd['argument']} != the shard-shape sum {want}")
        need(bpd["peak"] <= cap, f"(19) {arch} {shape} {rec['mesh']}: peak {bpd['peak']} "
             f"above the card's {cap} bytes")
        info, cfg = INPUT_SHAPES[shape], get_config(arch)
        tokens = info["global_batch"] * (1 if info["kind"] == "decode" else info["seq_len"])
        model = (6.0 if info["kind"] == "train" else 2.0) * cfg.active_params() * tokens
        model /= rec["n_devices"]
        need(rec["flops"] >= DRYRUN_FLOPS_SHARE * model, f"(19) {arch} {shape} "
             f"{rec['mesh']}: {rec['flops']:.3e} operations, below {DRYRUN_FLOPS_SHARE} x the "
             f"model's {model:.3e} per device")
        cpu = DRYRUN_DIR / "cpu" / f"{arch}__{shape}__{rec['mesh'].replace('x', '_')}.json"
        est = (f"{json.loads(cpu.read_text())['bytes_per_device']['peak'] / 2**30:.2f} GiB"
               if cpu.exists() else "not finished by the deadline")
        coll = ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in rec["collective_bytes"].items())
        log(f"[19 dryrun] {arch} {shape} {rec['mesh']}: argument {bpd['argument']} B = the "
            f"shard-shape sum; peak {bpd['peak'] / 2**30:.2f} GiB on the card (CPU "
            f"FakeTensorMode + MemTracker estimate {est}), temp {bpd['temp'] / 2**30:.2f} GiB; "
            f"{rec['flops']:.4e} operations ({rec['flops'] / model:.2f} x the model's "
            f"{model:.4e}); bytes accessed {rec['bytes_accessed']:.4e}; collectives: "
            f"{coll or 'none'}; lower {rec['lower_s']} s, step {rec['step_s']} s")
    return records


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
        rows[0]["whatif_launches"] = phase_whatif(torch, card)
        olmoe_serve, olmoe_forward = phase_olmoe(torch, np, card)
        twins = phase_examples(torch, np, card)
        import gc

        gc.collect()            # the twins' trainers hold reference cycles
        torch.cuda.empty_cache()
        mesh = phase_mesh(torch, np, card)
        phase_dryrun(torch, card, t_start)
        for row in rows:
            if row["name"] == "flash_decode":
                row["olmoe_launches"] = olmoe_serve["flash_decode"]
                row["mesh_launches"] = sum(mesh["launches"])
            elif row["name"] == "flash_attention":
                row["olmoe_launches"] = olmoe_forward["flash_attention"]
            row["example_launches"] = sum(t[row["name"]] for t in twins.values())
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
