"""The sizes of a configuration file, and the weights made from a seed.

:func:`sizes` reads a configuration file of ``portbench/configs`` into the
sizes the reference needs, through the module of its architecture
(:func:`architecture`, :mod:`portbench.reference.arch`). :func:`spec` lists
the parameters of the port's tree (the names and shapes the port's model
takes: period-stacked leaves, the vocabulary padded to a multiple of 128)
with their initial distribution. :func:`make` draws them from the seed on
the device, one large call per leaf from one generator, in bfloat16, the
type they are trained and served in; the benchmark hands the same tensors
to the port, and the reference draws them again after the port's state is
freed.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

import torch

#: parameter type of every configuration here (the files state bfloat16)
DTYPE = torch.bfloat16
#: the checkout whose ``portbench/reference/arch`` holds the architectures
ROOT = Path(__file__).resolve().parents[2]


def architecture(name: str, root: Path = ROOT) -> ModuleType:
    """The module of architecture ``name``,
    ``portbench/reference/arch/<name>.py`` under ``root``, loaded by path."""
    rel = f"portbench/reference/arch/{name}.py"
    path = root / rel
    if not path.is_file():
        raise ValueError(f"unknown architecture {name!r}: add {rel} (see "
                         f"portbench/reference/arch/__init__.py)")
    spec = importlib.util.spec_from_file_location(f"portbench_arch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sizes(conf: dict, root: Path = ROOT) -> dict:
    """The sizes of configuration ``conf`` (a configuration file's JSON), as
    the module of its architecture reads them, and that module under
    ``arch``."""
    arch = architecture(conf["architecture"], root)
    return {**arch.sizes(conf), "arch": arch}


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 128) * 128


def spec(sz: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """``(path, shape, init, scale)`` of every parameter, paths sorted:
    the embedding, the final norm, the head, and each sub-layer's leaves of
    the architecture's period stacked over the periods. ``init`` is
    ``normal`` (times ``scale``), ``zeros``, ``ones``, or one of the
    architecture's ``INITS``."""
    d, vp = sz["d"], padded_vocab(sz["vocab"])
    out = [("embed/tok", (vp, d), "normal", 0.02),
           ("final_norm", (d,), "ones", 0.0),
           ("head/w", (d, vp), "normal", 0.02)]
    period = sz["arch"].period(sz)
    n = sz["layers"] // len(period)
    for j, leaves in enumerate(period):
        for name, shape, init, scale in leaves:
            out.append((f"blocks/sub{j}/{name}", (n, *shape), init, scale))
    return sorted(out)


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
        elif init == "zeros":
            yield path, torch.zeros(shape, dtype=DTYPE, device=device)
        else:
            yield path, sz["arch"].INITS[init](shape, sz, gen, device).to(DTYPE)


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
