"""Carry screening state from the JAX package into the port.

The reference's state travels as numpy arrays, so a run can hand its screen
over mid-stream and the tests can hold both packages to the same state:

* :func:`bocd_state_from_numpy` — the seven arrays of a ``PallasBOCD`` /
  ``bocd_step`` state (``log_r, mu, beta, kappa, alpha, rl, mu0``) as
  tensors on a device.
* :func:`fleet_snapshot_from_reference` — a ``FleetDetect.snapshot()`` dict
  taken with the reference's ``batched`` backend, rewritten for the port's
  ``FleetDetect.restore`` under a chosen screening backend.
* :func:`params_from_numpy` — a model parameter tree (nested dicts of
  arrays, as ``repro.models.model.init_params`` makes them) as tensors.
* :func:`opt_state_from_numpy` — an AdamW state (``step``, ``mu``, ``nu``,
  as ``repro.optim.adamw.AdamWState`` holds them) as the port's
  :class:`~repro_torch.optim.adamw.AdamWState`.
"""
from __future__ import annotations

import copy
from collections.abc import Mapping, Sequence

import numpy as np
import torch

#: order of the arrays in a ``bocd_step`` state
BOCD_STATE_KEYS = ("log_r", "mu", "beta", "kappa", "alpha", "rl", "mu0")


def bocd_state_from_numpy(
    arrays: Mapping | Sequence, device, dtype=torch.float32
) -> dict[str, torch.Tensor]:
    """The seven arrays of a fixed-slot BOCD state as tensors on ``device``.

    ``arrays`` is a mapping with the keys of :data:`BOCD_STATE_KEYS` or a
    sequence in that order. Returns ``log_r``/``mu``/``beta`` (K, B) and
    ``kappa``/``alpha`` (K, 1) in ``dtype``, ``rl`` (K, 1) int32 and
    ``mu0`` (B,) in ``dtype`` — the layouts :func:`repro_torch.kernels.
    bocd_step.bocd_step` takes.
    """
    if not isinstance(arrays, Mapping):
        arrays = dict(zip(BOCD_STATE_KEYS, arrays, strict=True))
    log_r = np.asarray(arrays["log_r"])
    if log_r.ndim != 2:
        raise ValueError(f"log_r must be (K, B), got shape {log_r.shape}")
    k, b = log_r.shape
    shapes = {"log_r": (k, b), "mu": (k, b), "beta": (k, b),
              "kappa": (k, 1), "alpha": (k, 1), "rl": (k, 1), "mu0": (b,)}
    out: dict[str, torch.Tensor] = {}
    for name in BOCD_STATE_KEYS:
        a = np.asarray(arrays[name])
        if a.size != int(np.prod(shapes[name])):
            raise ValueError(
                f"{name} has shape {a.shape}; expected {shapes[name]}"
            )
        a = a.reshape(shapes[name])
        dt = torch.int32 if name == "rl" else dtype
        out[name] = torch.tensor(a, dtype=dt, device=device)
    return out


def slots_from_batched(payload: Mapping) -> dict:
    """A reference ``BatchedBOCD.snapshot()`` (hypothesis rows, compacted,
    row-constant ``kappa_row``/``alpha_row``) as a slot-layout snapshot with
    one slot per hypothesis its ``max_hypotheses`` allows (64 when
    uncapped). Slots beyond the live rows are dead (``-inf`` mass), which
    the fixed-slot step recycles first, so the frontier is the one the rows
    hold; a recycled slot restarts from the prior, so the statistics it is
    padded with never enter a result."""
    from repro_torch.kernels.bocd_step import DEFAULT_SLOTS

    log_r = np.asarray(payload["log_r"], dtype=np.float64)
    k_rows, b = log_r.shape
    k = payload.get("max_hypotheses") or DEFAULT_SLOTS
    if k_rows > k:
        raise ValueError(f"{k_rows} live hypothesis rows do not fit {k} slots")
    pad = k - k_rows

    def padded(a, fill, shape):
        a = np.asarray(a).reshape(shape)
        return np.concatenate([a, np.full((pad,) + shape[1:], fill, a.dtype)])

    return {
        "layout": "slots",
        "n_series": int(payload["n_series"]),
        "hazard": float(payload["hazard"]),
        "max_hypotheses": int(k),
        "mu0": np.asarray(payload["mu0"], dtype=np.float64).copy(),
        "log_r": padded(log_r, -np.inf, (k_rows, b)),
        "mu": padded(payload["mu"], 0.0, (k_rows, b)),
        "beta": padded(payload["beta"], 1.0, (k_rows, b)),
        "kappa": padded(payload["kappa_row"], 1.0, (k_rows, 1)),
        "alpha": padded(payload["alpha_row"], 1.0, (k_rows, 1)),
        "rl": padded(np.asarray(payload["rl"]).astype(np.int32), 0, (k_rows, 1)),
        "t": int(payload["t"]),
    }


def fleet_snapshot_from_reference(snap: Mapping, backend: str = "torch") -> dict:
    """A reference ``FleetDetect.snapshot()`` from its ``batched`` backend,
    rewritten for the port's ``FleetDetect.restore`` under ``backend``.

    ``"batched"``/``"numpy"`` keep the row layout (the port's copy of
    ``BatchedBOCD`` restores it as is); ``"torch"``/``"cuda"`` get each
    cohort's screening state in the fixed-slot layout
    (:func:`slots_from_batched`). Fused (``MultiBOCD``) snapshots carry
    rows of many cohorts in one frontier and convert only to ``batched``.
    """
    out = copy.deepcopy(dict(snap))
    if backend in ("batched", "numpy"):
        return out
    if backend not in ("torch", "cuda"):
        raise ValueError(f"no snapshot conversion for backend {backend!r}")
    if out.get("fused") or out.get("multi") is not None:
        raise ValueError("fused (MultiBOCD) snapshots convert only to 'batched'")
    for cohort in out["cohorts"]:
        batch = cohort["batch"]
        if batch is None:
            continue
        kind, payload = batch
        if kind != "batch" or "kappa_row" not in payload:
            raise ValueError(f"cohort batch {kind!r} is not a BatchedBOCD snapshot")
        cohort["batch"] = ("batch", slots_from_batched(payload))
    return out


def _tensor_from_array(a, device, dtype) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy (jax hands out read-only views)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.as_tensor rejects: carry the bits.
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Mapping, device, dtype=None) -> dict:
    """A parameter tree of arrays (numpy, or anything ``np.asarray`` takes:
    a jax array of bfloat16 arrives as ml_dtypes' bfloat16) as the same
    tree of tensors on ``device``, bit for bit, or cast to ``dtype`` (a
    float32 cast of bfloat16 is exact)."""
    return {
        name: params_from_numpy(sub, device, dtype) if isinstance(sub, Mapping)
        else _tensor_from_array(sub, device, dtype)
        for name, sub in tree.items()
    }


def opt_state_from_numpy(state, device):
    """A reference ``AdamWState`` (or any object with ``step``, ``mu`` and
    ``nu``: a 0-d step and two trees of float32 arrays) as the port's
    :class:`~repro_torch.optim.adamw.AdamWState` on ``device``: the step
    as an int32 scalar, the moments float32, bit for bit."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
        mu=params_from_numpy(state.mu, device, torch.float32),
        nu=params_from_numpy(state.nu, device, torch.float32),
    )
