"""The serving driver: ``launch/serve.py`` ``serve`` from the port.

A batch is ``serve(cfg, params, prompts, gen=..., use_kernel=...)``: the
prefill of the whole batch, then greedy decoding through the cache, FALCON
watching each decode step's measured latency. The prompts are drawn from the
seed with the training stream's generator (one draw per batch index), so every
seed serves the same sizes. Set-up draws the weights and serves one batch,
which builds the kernels and warms every shape. The window serves batch after
batch until ``seconds`` have passed; with ``trace`` one more batch runs under
the profiler.

Once the window has closed and the port's state is freed, the reference runs
once over each of a sample of the window's requests, drawn from the seed,
with the tokens it served, and reads the widest gap by which a served token's
logit lies below the reference's best.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from portbench import bench, trace as trace_lib, yardstick
from portbench.drivers.common import (device_entry, end_to_end, finish, peak,
                                      port_config, print_split, sync)
from portbench.reference import data, serve as ref_serve, weights


def prompts(seed: int, index: int, batch: int, length: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**62, index]))
    return data.tokens(rng, (batch, length), vocab)


class Run:
    def __init__(self, cell: bench.Cell, seed: int, device) -> None:
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.sz = weights.sizes(cell.config, cell.root)
        self.arch = port_config(cell.config, self.sz)
        self.tr = cell.traffic
        marks = [("imports", time.perf_counter())]
        self.params = weights.nest(weights.make(self.sz, seed, self.device))
        marks.append(("weights", time.perf_counter()))
        self.batches = 0
        self.served: dict[int, np.ndarray] = {}
        self.failed: dict[int, int] = {}
        self.onsets = 0                   # FALCON's onsets flagged on the measured latency
        self.batch()                      # set-up: builds and warms every shape
        marks.append(("warm-up batch", time.perf_counter()))
        self.setup_marks = marks

    def batch(self) -> None:
        from repro_torch.launch.serve import serve

        tr = self.tr
        prompt = prompts(self.seed, self.batches, tr["batch"], tr["prompt_len"], self.sz["vocab"])
        res = serve(self.arch, self.params, prompt, gen=tr["gen"],
                         use_kernel=tr["use_kernel"], device=self.device)
        # The prefill's own choice is fed to the first decode step but is not
        # among ``res.tokens``: the served tokens are both.
        first = res.prefill_logits[:, -1].argmax(dim=-1).cpu().numpy()[:, None]
        self.served[self.batches] = np.concatenate([first, np.asarray(res.tokens)], axis=1)
        # A request fails when its last logits are not finite.
        self.failed[self.batches] = int((~torch.isfinite(res.logits.float()).all(dim=-1)).sum())
        self.onsets += len(res.events)
        self.batches += 1

    def free(self) -> None:
        self.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, first: int, last: int) -> list[tuple[int, int]]:
        """(batch, row) of ``sample_requests`` requests of batches
        ``first`` .. ``last - 1``, drawn from the seed."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed % 2**62, 1 << 20]))
        rows = [(b, r) for b in range(first, last) for r in range(self.tr["batch"])]
        pick = rng.choice(len(rows), size=min(self.tr["sample_requests"], len(rows)),
                          replace=False)
        return [rows[i] for i in sorted(pick)]

    def judge(self, picks, control: str | None = None) -> float:
        """The widest gap over the picked requests (of the control's first
        choices, with ``control``)."""
        params = weights.make(self.sz, self.seed, self.device)
        tr, widest = self.tr, 0.0
        for b, r in picks:
            prompt = prompts(self.seed, b, tr["batch"], tr["prompt_len"], self.sz["vocab"])[r]
            served = self.served[b][r]
            if control is None:
                g = ref_serve.served_gaps(params, prompt, served, self.sz, self.device)
            else:
                g = ref_serve.control_gaps(params, prompt, served, self.sz, self.device, control)
            widest = max(widest, float(g.max()))
        del params
        return widest


def flops_per_batch(sz: dict, tr: dict) -> float:
    """Model FLOPs of a batch: 2 * matmul parameters * every token processed
    (prompt and generated), the prompt's causal attention, and each decode
    step's products with the cache (4 * positions * heads * head size a
    layer)."""
    b, s0, gen = tr["batch"], tr["prompt_len"], tr["gen"]
    dense = 2.0 * yardstick.matmul_params(sz) * b * (s0 + gen)
    prefill = b * sz["arch"].mixer_flops_forward(sz, s0)
    decode = b * sz["layers"] * sum(4.0 * (s0 + i + 1) * sz["heads"] * sz["head_dim"]
                                    for i in range(gen))
    return dense + prefill + decode


def decode_bytes_per_batch(sz: dict, tr: dict) -> float:
    """What ``flash_decode`` must move over a batch: per launch, q and the
    output (B x H x hd) and the valid K and V rows (B x valid x KVH x hd),
    each once, in bfloat16; one launch per layer and step."""
    b, s0, gen, hd = tr["batch"], tr["prompt_len"], tr["gen"], sz["head_dim"]
    total = 0.0
    for i in range(gen):
        total += 2 * (2 * b * sz["heads"] * hd + 2 * b * (s0 + i + 1) * sz["kv_heads"] * hd)
    return total * sz["layers"]


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of the serving cell: the result line's fields, ``checks`` last."""
    device = torch.device(device)
    tr = cell.traffic
    r = Run(cell, seed, device)
    sync(device)
    setup_peak = peak(device)
    first = r.batches
    start = time.perf_counter()
    setup_s = start - t0
    print_split(t0, r.setup_marks)
    walls = []
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        r.batch()
        walls.append(time.perf_counter() - t)
    window_s = time.perf_counter() - start
    print("window batches (s, host clock):", " ".join(f"{w:.4f}" for w in walls), file=sys.stderr)
    batches = r.batches - first
    traced = trace_lib.profile(r.batch) if trace else None
    peak_bytes = max(setup_peak, peak(device))
    picks = r.sample(first, first + batches)
    r.free()
    gap = r.judge(picks)
    checks = {"served_gap": {"value": gap, "limit": cell.limits["served_gap"]}}
    correct = math.isfinite(gap) and gap <= cell.limits["served_gap"]
    tokens = batches * tr["batch"] * tr["gen"]
    ctx = {"driver": "serve", "batches": batches, "window_s": window_s,
           "flops_per_batch": flops_per_batch(r.sz, tr),
           "decode_bytes_per_batch": decode_bytes_per_batch(r.sz, tr), "trace": traced,
           "trace_units": 1}
    if trace:
        metrics = bench.per_layer_metrics(cell, ctx)
    else:
        metrics = end_to_end(cell, setup_s, tokens / window_s)
    out = {"correct": correct, "attempted": batches * tr["batch"],
           "failed": sum(r.failed[b] for b in range(first, first + batches)),
           "metrics": metrics, "device": device_entry(device, cell.chips, peak_bytes),
           "events": {"onsets": r.onsets}}
    return finish(out, traced, checks)


def study(cell: bench.Cell, seed: int, device, controls: bool) -> list[dict]:
    """The port's widest gap over a sample of the first batch and, with
    ``controls``, the fp8 control's over the same requests."""
    r = Run(cell, seed, device)
    picks = r.sample(0, 1)
    r.free()
    out = [{"side": "port", "served_gap": r.judge(picks)}]
    if controls:
        out.append({"side": "control_fp8", "served_gap": r.judge(picks, "fp8")})
    return out
