"""The comparison that decides ``correct`` in the serving cell, at a size the
CPU holds: served tokens agree with the reference, the fp8 control reads far
above the port, and a run whose decoding is broken underneath comes out not
correct."""
import time

import pytest
import torch

from portbench import bench
from portbench.drivers import serve

WORKLOADS = bench.benchmark()["workloads"]
SERVE = [w["name"] for w in WORKLOADS if bench.cell(w["name"]).traffic["driver"] == "serve"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_control_reads_far_above_the_port(name, small):
    """At each position of the served sequences, the token the fp8
    reference puts first lies below the float32 reference's best by far
    more than the port's served tokens do. The fp8 control's widest gap
    grows with depth (0.4-0.8 logits at 2-8 layers here, 5.0-6.3 at 40 on
    the card), so its limit is held on the card; here it must read ten
    times the port's."""
    c = small(name)
    c.traffic = dict(c.traffic, sample_requests=c.traffic["batch"])
    r = serve.Run(c, 2**31 + 31, "cpu")
    r.free()
    picks = r.sample(0, 1)
    assert r.judge(picks, "fp8") > max(10 * r.judge(picks), 0.1)


@pytest.mark.parametrize("name", SERVE)
def test_served_tokens_agree_with_the_reference(name, small):
    out = serve.run(small(name), 2**31 + 41, 0.2, False, "cpu", time.perf_counter())
    assert list(out) == KEYS + ["events", "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0


def _altered_token(monkeypatch):
    """Every seventh served token replaced, where it is produced, by the one
    the logits rank last."""
    from repro_torch.launch import serve as serve_lib

    real, calls = serve_lib._next_input, []

    def next_input(params, logits, cfg, b):
        calls.append(1)
        if len(calls) % 7 == 4:
            flipped = torch.full_like(logits, -1e9)
            flipped[..., : cfg.vocab_size] = -logits[..., : cfg.vocab_size]
            logits = flipped
        return real(params, logits, cfg, b)

    monkeypatch.setattr(serve_lib, "_next_input", next_input)


def _cache_unchanged(monkeypatch):
    """Each decode step leaves the cache as it found it."""
    from repro_torch.launch import serve as serve_lib

    real = serve_lib.make_decode_step

    def make(cfg, seq_len, *, use_kernel=False):
        step = real(cfg, seq_len, use_kernel=use_kernel)

        def decode(params, tokens, caches, pos):
            copy = {k: {n: t.clone() for n, t in c.items()} for k, c in caches.items()}
            return step(params, tokens, copy, pos)[0], caches

        return decode

    monkeypatch.setattr(serve_lib, "make_decode_step", make)


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", [_altered_token, _cache_unchanged])
def test_a_broken_serve_is_not_correct(name, fault, monkeypatch, small):
    c = small(name)
    c.traffic = dict(c.traffic, sample_requests=2 * c.traffic["batch"])
    fault(monkeypatch)
    out = serve.run(c, 2**31 + 43, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"] is False, out["checks"]
