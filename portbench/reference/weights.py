"""The sizes of a configuration file, and the weights made from a seed.

:func:`sizes` reads a configuration file of ``portbench/configs`` into the
sizes the reference needs. :func:`spec` lists the parameters of the port's
tree (the names and shapes the port's model takes: period-stacked leaves,
the vocabulary padded to a multiple of 128) with their initial
distribution; Mamba2's decay rates and step-size biases are drawn as
mamba_ssm's ``Mamba2`` draws them, so that some heads keep their state
across many chunks. :func:`make` draws them from the seed on the device, one
large call per leaf from one generator, in bfloat16, the type they are
trained and served in; the benchmark hands the same tensors to the port, and
the reference draws them again after the port's state is freed.
"""
from __future__ import annotations

import math

import torch

#: parameter type of every configuration here (the files state bfloat16)
DTYPE = torch.bfloat16


def sizes(conf: dict) -> dict:
    """The sizes of configuration ``conf`` (a configuration file's JSON)."""
    arch = conf["architecture"]
    if arch == "granite":
        d, h = conf["hidden_size"], conf["num_attention_heads"]
        return {
            "kind": "attn", "layers": conf["num_hidden_layers"], "d": d,
            "vocab": conf["vocab_size"], "eps": conf["rms_norm_eps"],
            "heads": h, "kv_heads": conf["num_key_value_heads"], "head_dim": d // h,
            "d_ff": conf["intermediate_size"], "rope_theta": conf["rope_theta"],
        }
    if arch == "mamba2":
        a = conf["assumed"]
        return {
            "kind": "mamba", "layers": conf["n_layer"], "d": conf["d_model"],
            "vocab": conf["vocab_size"], "eps": a["norm_eps"],
            "state": a["d_state"], "head_dim": a["headdim"], "expand": a["expand"],
            "groups": a["ngroups"], "conv": a["d_conv"], "chunk": a["chunk_size"],
            "a_range": tuple(a["A_init_range"]), "dt_range": (a["dt_min"], a["dt_max"]),
            "dt_floor": a["dt_init_floor"],
        }
    raise ValueError(f"unknown architecture {arch!r}")


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 128) * 128


def spec(sz: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """``(path, shape, init, scale)`` of every parameter, paths sorted;
    ``init`` is ``normal`` (times ``scale``), ``zeros``, ``ones``, or
    Mamba2's ``a_log`` and ``dt_bias`` (see :func:`_mamba_init`)."""
    d, n, vp = sz["d"], sz["layers"], padded_vocab(sz["vocab"])
    out = [("embed/tok", (vp, d), "normal", 0.02),
           ("final_norm", (d,), "ones", 0.0),
           ("head/w", (d, vp), "normal", 0.02)]
    if sz["kind"] == "attn":
        hd, h, kv, f = sz["head_dim"], sz["heads"], sz["kv_heads"], sz["d_ff"]
        block = [("attn/norm", (d,), "ones"), ("attn/wq", (d, h * hd), "normal"),
                 ("attn/wk", (d, kv * hd), "normal"), ("attn/wv", (d, kv * hd), "normal"),
                 ("attn/wo", (h * hd, d), "normal"), ("mlp/norm", (d,), "ones"),
                 ("mlp/wi_gate", (d, f), "normal"), ("mlp/wi_up", (d, f), "normal"),
                 ("mlp/wo", (f, d), "normal")]
    else:
        inner = sz["expand"] * d
        heads = inner // sz["head_dim"]
        bc = 2 * sz["groups"] * sz["state"]
        w = sz["conv"]
        block = [("mamba/norm", (d,), "ones"), ("mamba/w_z", (d, inner), "normal"),
                 ("mamba/w_x", (d, inner), "normal"), ("mamba/w_bc", (d, bc), "normal"),
                 ("mamba/w_dt", (d, heads), "normal"), ("mamba/dt_bias", (heads,), "dt_bias"),
                 ("mamba/a_log", (heads,), "a_log"), ("mamba/d_skip", (heads,), "ones"),
                 ("mamba/conv_x", (w, inner), "conv"), ("mamba/conv_bc", (w, bc), "conv"),
                 ("mamba/out_norm", (inner,), "ones"), ("mamba/w_out", (inner, d), "normal")]
    for name, shape, init in block:
        scale = 0.1 if init == "conv" else 0.02
        out.append((f"blocks/sub0/{name}", (n, *shape),
                    "normal" if init == "conv" else init, scale))
    return sorted(out)


def _mamba_init(init: str, shape, sz: dict, gen, device) -> torch.Tensor:
    """mamba_ssm ``Mamba2``'s draw, in float32: ``a_log = log(A)`` with A
    uniform in ``a_range``; ``dt_bias`` the inverse softplus of a step size
    log-uniform in ``dt_range``, floored at ``dt_floor``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    if init == "a_log":
        lo, hi = sz["a_range"]
        return torch.log(lo + (hi - lo) * u)
    lo, hi = sz["dt_range"]
    dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u).clamp(min=sz["dt_floor"])
    return dt + torch.log(-torch.expm1(-dt))


def draw(sz: dict, seed: int, device):
    """Yield ``(path, tensor)`` for every parameter, drawn from ``seed`` on
    ``device`` in the order of :func:`spec`, one leaf at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    for path, shape, init, scale in spec(sz):
        if init == "normal":
            t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            yield path, t.mul_(scale).to(DTYPE)
        elif init == "ones":
            yield path, torch.ones(shape, dtype=DTYPE, device=device)
        elif init in ("a_log", "dt_bias"):
            yield path, _mamba_init(init, shape, sz, gen, device).to(DTYPE)
        else:
            yield path, torch.zeros(shape, dtype=DTYPE, device=device)


def make(sz: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``{path: tensor}`` of every parameter, drawn from ``seed``."""
    return dict(draw(sz, seed, device))


def nest(flat: dict) -> dict:
    """The nested tree of ``{"a/b/c": tensor}``."""
    out: dict = {}
    for path, v in flat.items():
        *parents, name = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = v
    return out
