"""Sharding rules: logical parameter axes -> mesh specs — the twin of
:mod:`repro.sharding`, on a ``torch.distributed`` :class:`DeviceMesh`.

The port's spec record is :class:`P`, the counterpart of JAX's
``PartitionSpec``: a tuple with one entry per tensor dimension, each
``None`` (replicated), a mesh axis name or a tuple of names (the dimension
split over several axes, the first the most major). A one-name tuple is
stored as the name, as ``PartitionSpec`` stores it.

The ambient mesh is the twin of ``repro.compat.set_mesh`` /
``ambient_mesh``: code that adapts to a mesh (the expert-parallel MoE, the
sharded decode step) reads :func:`ambient_mesh`, which is the mesh the
caller entered with :func:`set_mesh`, or None. It is kept per thread of
control (a :class:`contextvars.ContextVar`), never as a process global.
"""
from __future__ import annotations

import contextlib
import contextvars

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *entries):
        out = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                if len(e) == 1:
                    e = e[0]
                elif not e:
                    e = None
            out.append(e)
        return super().__new__(cls, out)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


def ambient_mesh():
    """The mesh the caller entered with :func:`set_mesh`, or None."""
    return _MESH.get()


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)
