"""Batched serving driver with FALCON latency monitoring — the twin of
:mod:`repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        [--no-smoke] --requests 8 --prompt-len 32 --gen 16 [--use-kernel] \
        [--inject gpu:1:0.5:5:200] [--device cpu]

Serves a batch of requests through the real prefill + decode path. FALCON's
detector watches the per-token decode latency exactly as it watches training
iteration time; with ``--inject`` the latency comes from the cluster
performance model with the fail-slow applied (``TrainingSimulator`` of one
8-GPU node, tp = 2, dp = 4), otherwise from the host clock around each
decode step, synchronised with the card.

``--smoke`` (the default) serves the reduced config; ``--no-smoke`` the
published width. Note that a fail-slow starting at 5 s of modeled time, as
``gpu:1:0.5:5:200``, fires only at full width: the modeled time per token of
the smoke config is ~1.2e-4 s, so there it takes a start of a few ms
(``gpu:1:0.5:0.003:200``).

The loop is :func:`serve`, which takes the parameters and the prompt and
returns the generated tokens and the FALCON events, so that callers can
hand it any parameters (the tests: the JAX package's, carried over).
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.cluster.injector import FailSlowInjector
from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
from repro_torch.cluster.spec import ClusterSpec, ModelSpec
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.core.detector import FalconDetect
from repro_torch.core.events import FailSlowEvent
from repro_torch.device import resolve_device
from repro_torch.launch.train import parse_injection
from repro_torch.models import layers, model as model_lib, transformer
from repro_torch.obs import runtime
from repro_torch.serve.serve_step import (DecodeGraph, graphable, make_decode_step,
                                          make_prefill_step)

#: FalconDetect's verification window on the per-token latency stream
VERIFY_WINDOW = 6

def serve_simulator(cfg: ArchConfig, total: int, device=None) -> TrainingSimulator:
    """The performance model behind the latency signal: one node of 8 GPUs,
    tp = 2, dp = 4, pp = 1, sized from the served model."""
    return TrainingSimulator(
        cluster=ClusterSpec(n_nodes=1, gpus_per_node=8),
        job=JobSpec(
            model=ModelSpec(layers=cfg.num_layers, hidden=max(cfg.d_model, 1024),
                            seq_len=total, vocab=cfg.vocab_size),
            tp=2, dp=4, pp=1, micro_batches=8,
        ),
        device=device,
    )


@dataclass
class ServeResult:
    """What :func:`serve` returns."""

    #: (B, gen) generated tokens (codebook 0 for audio)
    tokens: np.ndarray
    #: (step, event) for every FALCON onset flagged during decode
    events: list[tuple[int, FailSlowEvent]]
    #: last-token logits of the prefill, (B, 1, V[, K])
    prefill_logits: torch.Tensor
    #: logits of the last decode step
    logits: torch.Tensor
    #: host seconds of the prefill (synchronised with the device)
    prefill_s: float
    #: host seconds of each decode step (synchronised with the device)
    step_s: list[float]
    #: the latency fed to the detector at each step (modeled with injections)
    latencies: list[float]
    #: True when the latencies came from the performance model
    modeled: bool
    #: decode steps served by replaying a CUDA graph (0 where the step
    #: cannot be captured: see :func:`serve`)
    graph_steps: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_input(params, logits, cfg, b):
    """Greedy next-token input of the decode step and the token recorded
    (codebook 0 for audio). Audio logits (B, 1, K, V) give a (B, 1, K)
    token; a vision-embeds model is fed the embedding of its token."""
    nxt = torch.argmax(logits[:, -1], dim=-1)
    if cfg.modality == "audio_codes":
        return nxt.reshape(b, 1, cfg.num_codebooks), nxt[..., 0]
    tok = nxt.reshape(b, 1)
    if cfg.modality == "vision_embeds":
        return layers.apply_embed(params["embed"], tok, cfg), nxt
    return tok, nxt


@torch.no_grad()
def serve(
    cfg: ArchConfig,
    params: dict,
    prompt,
    *,
    gen: int,
    use_kernel: bool = False,
    inject=(),
    device=None,
) -> ServeResult:
    """Prefill ``prompt`` and decode ``gen`` tokens greedily, feeding the
    per-token latency to FALCON.

    ``prompt`` is a (B, S) token array ((B, S, K) for audio), or a prefill
    batch dict (``{"embeds", "positions"}`` for a vision-embeds model).
    ``params`` live on ``device`` (None = the card, raising when there is
    none); ``inject`` holds ``kind:target:severity:start:duration`` texts or
    :class:`Injection` objects. ``use_kernel`` runs the prefill's attention
    through ``flash_attention`` and the decode's cache read through
    ``flash_decode`` (:mod:`repro_torch.serve.serve_step`).

    The call is one ``serve.batch`` span of :mod:`repro_torch.obs.runtime`:
    ``serve.prefill`` (the region ``prefill_s`` times), then per generated
    token ``serve.decode`` over ``serve.dispatch`` (the decode step's
    enqueue), ``serve.wait`` (the synchronise; ``step_s`` runs from the
    dispatch's start to the wait's end), ``falcon.observe`` and
    ``serve.sample``.

    Where :func:`repro_torch.serve.serve_step.graphable` holds (a CUDA
    device, no ambient mesh, no serve window), the decode runs on a side
    stream with its position on the device: the first step eagerly, which
    warms it, then ``serve.capture`` records one step into a CUDA graph
    (:class:`~repro_torch.serve.serve_step.DecodeGraph`), and every later
    step's ``serve.dispatch`` copies in the token and position and replays
    it (``graph_steps`` counts them; so does the runtime counter
    ``serve.graph_replays``, once a batch). Elsewhere every step runs
    eagerly at a host position.
    """
    with runtime.span("serve.batch"):
        return _serve(cfg, params, prompt, gen, use_kernel, inject, resolve_device(device))


def _serve(cfg, params, prompt, gen, use_kernel, inject, dev) -> ServeResult:
    batch = dict(prompt) if isinstance(prompt, dict) else {"tokens": prompt}
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    lead = batch["embeds"] if cfg.modality == "vision_embeds" else batch["tokens"]
    b, s0 = lead.shape[0], lead.shape[1]
    total = s0 + gen

    sim = serve_simulator(cfg, total, device=dev)
    injector = FailSlowInjector([
        parse_injection(t) if isinstance(t, str) else t for t in inject
    ])
    detector = FalconDetect(cluster=sim, verify_window=VERIFY_WINDOW)
    prefill = make_prefill_step(cfg, s0, use_kernel=use_kernel)
    decode = make_decode_step(cfg, total, use_kernel=use_kernel)

    _sync(dev)
    with runtime.timed("serve.prefill") as timed_prefill:
        prefill_logits, caches = prefill(params, batch)
        _sync(dev)
    caches = transformer.grow_caches(caches, cfg, total)

    tok, _ = _next_input(params, prefill_logits, cfg, b)
    graph = stream = None
    if gen > 1 and graphable(cfg, total, dev):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            graph = DecodeGraph(decode, params, caches, tok)
    logits = prefill_logits
    events, step_s, latencies, generated = [], [], [], []
    wall = 0.0
    with torch.cuda.stream(stream):
        for step in range(gen):
            if graph is not None and step == 1:
                with runtime.span("serve.capture"):
                    graph.capture()
            with runtime.span("serve.decode", token=step):
                with runtime.timed("serve.dispatch") as dispatch:
                    if graph is None:
                        logits, caches = decode(params, tok, caches, s0 + step)
                    else:
                        logits = graph(tok, s0 + step)
                with runtime.timed("serve.wait") as wait:
                    _sync(dev)
                measured = wait.end - dispatch.start
                with runtime.span("falcon.observe"):
                    injector.apply(sim.state, wall)
                    latency = sim.iteration_time() if injector.injections else measured
                    wall += latency
                    ev = detector.observe(latency, wall)
                    if ev is not None:
                        events.append((step, ev))
                step_s.append(measured)
                latencies.append(latency)
                with runtime.span("serve.sample"):
                    tok, rec = _next_input(params, logits, cfg, b)
                    generated.append(rec.cpu().numpy())
        logits = logits.clone()   # the graph's output is its own
    if stream is not None:
        torch.cuda.current_stream(dev).wait_stream(stream)
    graph_steps = graph.replays if graph is not None else 0
    runtime.count("serve.graph_replays", torch.tensor(graph_steps))
    tokens = np.stack(generated, axis=1) if generated else np.zeros((b, 0), np.int64)
    return ServeResult(tokens=tokens, events=events, prefill_logits=prefill_logits,
                       logits=logits, prefill_s=timed_prefill.seconds, step_s=step_s,
                       latencies=latencies, modeled=bool(injector.injections),
                       graph_steps=graph_steps)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="serve the reduced config (--no-smoke: the published width)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--inject", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if cfg.modality == "vision_embeds":
        raise SystemExit(f"{cfg.name} takes embeddings, not tokens: call serve() "
                         "with an {'embeds', 'positions'} batch")
    dev = resolve_device(args.device)
    b, s0 = args.requests, args.prompt_len
    print(f"serving {b} requests x ({s0} prompt + {args.gen} new) on {cfg.name} ({dev})")

    params = model_lib.init_params(cfg, args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab_size, (b, s0))
    if cfg.modality == "audio_codes":
        prompt = prompt[..., None].repeat(cfg.num_codebooks, -1)
    res = serve(cfg, params, prompt, gen=args.gen, use_kernel=args.use_kernel,
                inject=args.inject, device=dev)
    for step, ev in res.events:
        print(f"  token {step}: FALCON flags {ev.root_cause.value} "
              f"on {ev.components} ({ev.t_healthy:.3f}s -> {ev.t_slow:.3f}s)")
    if not bool(torch.isfinite(res.logits.float()).all()):
        raise RuntimeError("non-finite logits")
    wall = sum(res.latencies)
    rate = b * args.gen / max(wall, 1e-9)
    print(f"prefill: {res.prefill_s:.2f}s   decode: {args.gen} tokens/seq, "
          + (f"{rate:.1f} tok/s (modeled)" if res.modeled else f"{rate:.1f} tok/s"))
    print(f"sample continuation: {res.tokens[0].tolist()}")


if __name__ == "__main__":
    main()
