"""Serve steps — the twin of :mod:`repro.serve.serve_step`: prefill (fill
caches, return last-token logits) and decode (one new token against a
``seq_len`` cache).

Sliding-window policy: architectures with ``long_context == "sliding"`` use
their configured window past 64k tokens of context (sub-quadratic
per-token cost AND bounded attention reads).

``use_kernel`` takes the prefill's attention to the CUDA flash-attention
kernel and the decode's cache read to the CUDA flash-decode kernel; without
it both run the plain blocked attention and einsum read of the reference.
The prefill's Mamba2 layers run the plain chunked SSD scan and a Mamba2
decode step is the recurrence, kernel or not.

Under an ambient mesh (:func:`repro_torch.sharding.set_mesh`) both steps
run per rank on local shards with explicit collectives
(:mod:`repro_torch.serve.sharded_prefill`,
:mod:`repro_torch.serve.sharded_decode`).

:class:`DecodeGraph` holds the decode step's position on the device and
replays the step from a CUDA graph; :func:`graphable` says where it can:
on a CUDA device, with no ambient mesh and no serve window.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as _fa, flash_decode as _fd
from repro_torch.models import attention, layers, model as model_lib, moe, ssm, transformer
from repro_torch.obs import runtime
from repro_torch.sharding import ambient_mesh

#: the kernel wrappers whose launch counters a replay advances by the
#: launches its capture recorded
_COUNTED = (_fd.flash_decode, _fa.flash_attention)


def serve_window(cfg: ArchConfig, seq_len: int) -> int:
    """The attention window used when serving at this context length."""
    if cfg.long_context == "sliding" and cfg.sliding_window and seq_len > 65536:
        return cfg.sliding_window
    return 0


def make_decode_step(
    cfg: ArchConfig, seq_len: int, *, use_kernel: bool = False
) -> Callable:
    window = serve_window(cfg, seq_len)

    def decode_step(params, tokens, caches, pos):
        mesh = ambient_mesh()
        if mesh is not None:
            from repro_torch.serve import sharded_decode

            return sharded_decode.decode_step(
                params, tokens, caches, pos, cfg, mesh, window=window,
                use_kernel=use_kernel,
            )
        return model_lib.decode_step(
            params, tokens, caches, pos, cfg, window=window,
            use_kernel=use_kernel,
        )

    return decode_step


def graphable(cfg: ArchConfig, seq_len: int, device) -> bool:
    """Whether the decode step can run from a CUDA graph
    (:class:`DecodeGraph`): on a CUDA device, with no ambient mesh (the
    sharded step takes host positions) and no serve window (the sliding
    read slices the cache at a host offset)."""
    return (torch.device(device).type == "cuda" and ambient_mesh() is None
            and not serve_window(cfg, seq_len))


class DecodeGraph:
    """A decode step of :func:`make_decode_step` at a position held on the
    device, captured once into a CUDA graph and replayed for each later
    token.

    The graph's static inputs are the step's input (the token, or the
    embedding of a vision-embeds model), a 0-d int32 position and
    ``caches``, which every step updates in place; ``params`` are read in
    place. A call before :meth:`capture` runs the step eagerly on the same
    static inputs: the first one warms, on the capturing stream, every
    kernel and library handle that the capture records. Make, call and
    capture it on a side stream: the default stream cannot be captured.
    """

    def __init__(self, decode: Callable, params: dict, caches: dict, tok: torch.Tensor):
        self.decode, self.params, self.caches = decode, params, caches
        self.tok = torch.empty_like(tok)
        self.pos = torch.zeros((), dtype=torch.int32, device=tok.device)
        self.graph = None
        #: the graph's output; each replay overwrites it
        self.logits = None
        #: (wrapper, launches) the capture recorded
        self.launches: tuple = ()
        #: steps served by replay
        self.replays = 0

    def __call__(self, tok: torch.Tensor, pos: int) -> torch.Tensor:
        """The logits of the step at ``pos`` with input ``tok``: the input
        copied and the position written on the device, then the step run
        eagerly or, once captured, replayed (its logits are then
        :attr:`logits`)."""
        self.tok.copy_(tok)
        self.pos.fill_(pos)
        if self.graph is None:
            return self.decode(self.params, self.tok, self.caches, self.pos)[0]
        self.graph.replay()
        self.replays += 1
        for wrapper, n in self.launches:
            wrapper.launches += n
        return self.logits

    def capture(self) -> None:
        """Capture one step. Nothing of :mod:`repro_torch.obs.runtime`
        records inside; the kernel wrappers' launch counters stay as they
        were (the capture runs nothing) and advance by the captured
        launches at each replay."""
        before = [w.launches for w in _COUNTED]
        graph = torch.cuda.CUDAGraph()
        with runtime.paused():
            graph.capture_begin()
            try:
                self.logits, _ = self.decode(self.params, self.tok, self.caches, self.pos)
            finally:
                graph.capture_end()
        self.launches = tuple((w, w.launches - n) for w, n in zip(_COUNTED, before))
        for w, n in zip(_COUNTED, before):
            w.launches = n
        self.graph = graph


# ------------------------------------------------------------------ prefill
def make_prefill_step(
    cfg: ArchConfig, seq_len: int, *, seq_shard: bool = True, use_kernel: bool = False
) -> Callable:
    """Forward over the prompt, returning (last-token logits, filled caches
    stacked over periods: (n_periods, B, S, KVH, hd) for attention, the
    final state and conv histories for Mamba2). ``use_kernel`` runs the
    attention through ``flash_attention``, one launch per attention layer.
    Under an ambient mesh the caches come placed by ``cache_specs(...,
    seq_shard=seq_shard)`` and the attention is the plain blocked one, which
    has no kernel route: there ``use_kernel`` raises ValueError."""
    window = serve_window(cfg, seq_len)

    def prefill(params, batch):
        mesh = ambient_mesh()
        if mesh is not None:
            if use_kernel:
                raise ValueError("the sharded prefill has no kernel route: build the "
                                 "step without use_kernel to run it under a mesh")
            from repro_torch.serve import sharded_prefill

            return sharded_prefill.prefill_step(params, batch, cfg, mesh, window=window,
                                                seq_shard=seq_shard)
        x = (
            batch["embeds"].to(cfg.activation_dtype)
            if cfg.modality == "vision_embeds"
            else layers.apply_embed(params["embed"], batch["tokens"], cfg)
        )
        positions = model_lib._positions(batch, cfg, x.shape[1])
        h = x
        per_period = []
        for i in range(cfg.n_periods):
            period = transformer.period_view(params["blocks"], i)
            cache_out = {}
            for j, sub in enumerate(cfg.period):
                key = f"sub{j}"
                p = period[key]
                if sub.mixer == "attn":
                    dh, k, v = attention.attend(p["attn"], h, cfg, positions, window=window,
                                                use_kernel=use_kernel)
                    c = {"k": k, "v": v}
                else:
                    dh, c = ssm.mamba_forward(p["mamba"], h, cfg)
                h = layers.residual(h, dh, cfg)
                cache_out[key] = c
                if sub.mlp == "mlp":
                    h = layers.residual(h, layers.apply_mlp(p["mlp"], h, cfg), cfg)
                elif sub.mlp == "moe":
                    y, _ = moe.apply_moe(p["moe"], h, cfg)
                    h = layers.residual(h, y, cfg)
            per_period.append(cache_out)
        caches = {
            key: {name: torch.stack([c[key][name] for c in per_period])
                  for name in per_period[0][key]}
            for key in per_period[0]
        }
        h = layers.rmsnorm(h, params["final_norm"], cfg.norm_eps)
        logits = layers.apply_head(params["head"], h[:, -1:], cfg)
        return logits, caches

    return prefill
