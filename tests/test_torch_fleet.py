"""The port's fleet screen (``repro_torch.core.detector.FleetDetect``) held
against the JAX package's.

* On the same ``fleet_matrix``-style (T, B) input, the port's ``torch``
  backend (float64, CPU), its ``cuda`` backend on a CPU device (the plain
  float32 step) and its numpy ``batched`` backend raise exactly the flags of
  the reference's ``batched`` backend.
* The same with the adaptive re-tune on, and with the fused numpy frontier.
* A reference snapshot taken after 100 ticks, converted with
  ``repro_torch.convert.fleet_snapshot_from_reference`` and restored into
  the port, raises the same flags as the reference over 100 more ticks.
* The screening registry: names, ``auto`` on the card or with an explicit
  CPU device, and no ``pallas``.
"""
import numpy as np
import pytest
import torch

from repro.core.detector import FleetDetect as RefFleetDetect
from repro_torch.convert import fleet_snapshot_from_reference
from repro_torch.core import bocd
from repro_torch.core.detector import FalconDetect, FleetDetect


def fleet_matrix(n_workers=24, n_ticks=400, seed=0):
    """Per-column step changes at varied onsets/levels/jumps (the reference
    test suite's generator)."""
    x = np.empty((n_ticks, n_workers))
    for col in range(n_workers):
        r = np.random.default_rng(seed * 1000 + col)
        lvl = 1.0 + 0.5 * (col % 3)
        jump = 1.0 + 0.15 + 0.02 * (col % 7)
        cp = (100 + 7 * col) % (n_ticks // 2) + 50
        x[:, col] = np.concatenate([
            r.normal(lvl, 0.01 * lvl, cp),
            r.normal(lvl * jump, 0.01 * lvl * jump, n_ticks - cp),
        ])
    return x


def _flags(fleet, x, start=0):
    return sorted(
        (start + t, f.worker, f.change_point.index)
        for t in range(x.shape[0]) for f in fleet.tick(x[t])
    )


@pytest.mark.parametrize("backend", ["batched", "torch", "cuda"])
@pytest.mark.parametrize("seed", [0, 1])
def test_flags_identical_to_reference_batched(backend, seed):
    x = fleet_matrix(seed=seed)
    want = _flags(RefFleetDetect(n_workers=x.shape[1], backend="batched"), x)
    got = _flags(FleetDetect(n_workers=x.shape[1], backend=backend,
                             device="cpu"), x)
    assert got == want
    assert {w for _, w, _ in want} == set(range(x.shape[1]))


@pytest.mark.parametrize("backend,kwargs", [
    ("torch", {"adapt_every": 50}),
    ("cuda", {"adapt_every": 50}),
    ("batched", {"fused": True}),
])
def test_adaptive_and_fused_screens_flag_like_reference(backend, kwargs):
    """The adaptive re-tune (hazard and slot frontier re-derived every 50
    ticks) and the fused numpy frontier keep the reference's flags."""
    x = fleet_matrix(seed=1)
    ref = RefFleetDetect(n_workers=x.shape[1], backend="batched", **kwargs)
    port = FleetDetect(n_workers=x.shape[1], backend=backend, device="cpu",
                       **kwargs)
    assert _flags(port, x) == _flags(ref, x)
    assert port.last_tuning == ref.last_tuning


@pytest.mark.parametrize("backend", ["batched", "torch"])
def test_snapshot_carried_across_gives_identical_flags(backend):
    """Snapshot the reference after 100 ticks, restore into the port, run
    100 more ticks on both: identical flags."""
    x = fleet_matrix(n_workers=24, n_ticks=200, seed=2)
    ref = RefFleetDetect(n_workers=24, backend="batched")
    _flags(ref, x[:100])
    snap = ref.snapshot()
    port = FleetDetect(n_workers=24, backend=backend, device="cpu")
    port.restore(fleet_snapshot_from_reference(snap, backend=backend))
    want = _flags(ref, x[100:], start=100)
    got = _flags(port, x[100:], start=100)
    assert got == want
    assert want  # the second half carries most of the onsets


def test_slot_snapshot_round_trip():
    """A fixed-slot backend's own snapshot restores bit for bit."""
    x = fleet_matrix(n_workers=6, n_ticks=200, seed=3)
    a = FleetDetect(n_workers=6, backend="torch", device="cpu")
    _flags(a, x[:100])
    b = FleetDetect(n_workers=6, backend="torch", device="cpu")
    b.restore(a.snapshot())
    assert _flags(a, x[100:]) == _flags(b, x[100:])
    with pytest.raises(ValueError, match="convert"):
        b._cohorts[0].batch.restore(
            RefFleetDetect(n_workers=6, backend="batched").snapshot()
            | {"layout": "rows"}
        )


def test_screening_registry():
    assert bocd.select_backend("numpy").name == "batched"
    assert bocd.select_backend("torch", device="cpu").device == "cpu"
    assert bocd.select_backend("auto", device="cpu").name == "torch"
    with pytest.raises(ValueError, match="registered: .*'cuda'.*'torch'"):
        bocd.select_backend("pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bocd.select_backend("auto")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FleetDetect(n_workers=4)
    # a backend factory carries its device into the state it makes
    det = bocd.select_backend("cuda", device="cpu").make(3, max_hypotheses=4)
    assert det.device.type == "cpu" and det.dtype == torch.float32


def test_falcon_detect_backends_pinpoint_alike():
    """FalconDetect on its exact scalar recursion and on the plain torch
    step (one-column state behind the scalar facade) pinpoints the same
    fail-slow on a small simulated job."""
    from repro_torch.cluster.simulator import JobSpec, TrainingSimulator
    from repro_torch.cluster.spec import ClusterSpec, ModelSpec

    history = {}
    for backend in ("scalar", "torch"):
        sim = TrainingSimulator(
            cluster=ClusterSpec(n_nodes=1),
            job=JobSpec(model=ModelSpec(layers=8, hidden=1024, seq_len=1024,
                                        vocab=32000),
                        tp=2, dp=2, pp=2, micro_batches=8),
            reduction="vectorized",
        )
        det = FalconDetect(cluster=sim, backend=backend, device="cpu")
        rng = np.random.default_rng(4)
        events = []
        for i in range(120):
            if i == 60:
                sim.state.devices[5].compute_speed = 0.5
            ev = det.observe(
                sim.iteration_time() * float(rng.normal(1, 0.003)), float(i)
            )
            if ev is not None:
                events.append(ev)
        history[backend] = [
            (e.start_time, e.root_cause, tuple(e.components)) for e in events
        ]
    assert history["torch"] == history["scalar"]
    assert history["scalar"] and history["scalar"][0][2] == ("gpu:5",)
