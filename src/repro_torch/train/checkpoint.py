"""Checkpointing — the twin of :mod:`repro.train.checkpoint`: in-memory (the
paper's fast 'M' variant used by topology adjustment) and disk ('D'
baseline, used by S4 checkpoint-and-restart).

Trees (nested dicts, NamedTuples such as ``AdamWState``, lists and tuples
of tensors) are flattened to path-keyed arrays in the reference's layout:
dict keys by name, NamedTuple fields as ``.field``, sequence items by
index, ``/``-joined; bfloat16 leaves are stored as their ``uint16`` bits
under ``key::bf16``. The disk format is one ``.npz``, so a checkpoint the
JAX package wrote restores here and the reverse.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _children(tree):
    """``(path part, child)`` of a tree node, in the reference's order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{name}", getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _rebuild(tree, values):
    """A node like ``tree`` whose children are ``values`` (in
    :func:`_children` order)."""
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def _map(fn, tree, path=""):
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    return _rebuild(tree, [_map(fn, sub, f"{path}/{k}" if path else k) for k, sub in kids])


def _by_path(tree) -> dict:
    out: dict = {}
    _map(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}

    def put(path, leaf):
        key = path + ("::bf16" if leaf.dtype == torch.bfloat16 else "")
        flat[key] = _to_numpy(leaf)

    _map(put, tree)
    return flat


@dataclass
class CheckpointManager:
    directory: str

    _memory: object | None = field(init=False, default=None)
    _devices: dict = field(init=False, default_factory=dict)
    last_save_time: float = field(init=False, default=0.0)
    last_restore_time: float = field(init=False, default=0.0)

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)

    # ---- memory (paper's M: dump params into host memory, swap via RDMA)
    def save_memory(self, tree) -> float:
        """Copy every leaf into host memory, noting the device it came from."""
        t0 = time.monotonic()
        self._memory = _map(lambda _, x: x.detach().to("cpu", copy=True), tree)
        self._devices = {path: x.device for path, x in _by_path(tree).items()}
        self.last_save_time = time.monotonic() - t0
        return self.last_save_time

    def restore_memory(self, like=None):
        """The in-memory checkpoint as a tree of tensors on the devices they
        were saved from (or like ``like``: on its devices, in its types)."""
        assert self._memory is not None, "no in-memory checkpoint"
        t0 = time.monotonic()
        if like is None:
            out = _map(lambda path, x: x.to(self._devices[path]), self._memory)
        else:
            saved = _by_path(self._memory)
            out = _map(lambda path, leaf: saved[path].to(leaf.device, leaf.dtype), like)
        self.last_restore_time = time.monotonic() - t0
        return out

    # ---- disk (baseline D)
    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def save_disk(self, tree, step: int) -> float:
        t0 = time.monotonic()
        np.savez(self.path(step), **_flatten(tree))
        self.last_save_time = time.monotonic() - t0
        return self.last_save_time

    def restore_disk(self, like, step: int):
        """The checkpoint of ``step`` as a tree like ``like``: each leaf in
        ``like``'s type, on its device."""
        t0 = time.monotonic()
        with np.load(self.path(step)) as data:
            flat = dict(data)

        def get(path, leaf):
            if path + "::bf16" in flat:
                raw = np.ascontiguousarray(flat[path + "::bf16"]).view(np.int16)
                t = torch.from_numpy(raw).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(flat[path]))
            return t.to(device=leaf.device, dtype=leaf.dtype)

        out = _map(get, like)
        self.last_restore_time = time.monotonic() - t0
        return out

    def latest_step(self) -> int | None:
        steps = [
            int(f[5:13])
            for f in os.listdir(self.directory)
            if f.startswith("ckpt_") and f.endswith(".npz")
        ]
        return max(steps) if steps else None
