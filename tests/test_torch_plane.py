"""The port's control plane (``repro_torch.controlplane.ControlPlane``) held
against the JAX package's: one simulated job (tp=2, dp=2, pp=2 on one
8-GPU node) with a throttled GPU, ticked through the fleet screen, the
pinpoint and the mitigation ladder in both packages on the CPU.

* Float64 (the port's ``torch`` screen and reduction): the serialized event
  logs (``event_record``) are equal, floats to rtol 1e-9.
* The ``cuda`` backends on a CPU device (the kernels' plain float32
  versions) and ``auto`` with an explicit CPU device: the same Flag /
  Diagnosis / Mitigation decisions at the same ticks — the contract the
  card run is held to.
"""
import numpy as np
import pytest

from repro.cluster import injector as ref_inj
from repro.cluster import simulator as ref_sim
from repro.cluster import spec as ref_spec
from repro.controlplane import ControlPlane as RefPlane
from repro.controlplane import event_record as ref_record
from repro_torch.cluster import injector as inj
from repro_torch.cluster import simulator as sim_mod
from repro_torch.cluster import spec
from repro_torch.controlplane import ControlPlane, event_record
from repro_torch.core import bocd

DT = 5.0
TICKS = 300


def _drive(plane, sim, injector, record):
    plane.register_job("job", sim, injector=injector, sample_period=DT)
    rng = np.random.default_rng(0)
    for tick in range(TICKS):
        injector.apply(sim.state, tick * DT)
        plane.tick({"job": sim.iteration_time() * float(rng.normal(1.0, 0.003))},
                   (tick + 1) * DT)
    return [record(e) for e in plane.events]


def _setup(S, I, C, **sim_kwargs):
    sim = S.TrainingSimulator(
        cluster=C.ClusterSpec(n_nodes=1),
        job=S.JobSpec(model=C.ModelSpec(layers=32, hidden=4096, seq_len=2048,
                                        vocab=50257),
                      tp=2, dp=2, pp=2, micro_batches=16),
        **sim_kwargs,
    )
    injector = I.FailSlowInjector([I.Injection(
        start=100 * DT, duration=150 * DT, kind=I.InjectionKind.GPU_SLOW,
        target=(3,), severity=0.5,
    )])
    return sim, injector


def _reference_log():
    sim, injector = _setup(ref_sim, ref_inj, ref_spec, reduction="vectorized")
    return _drive(RefPlane(screening_backend="batched"), sim, injector, ref_record)


def _assert_records_close(got, want, path="events"):
    if isinstance(want, float):
        assert isinstance(got, float), path
        np.testing.assert_allclose(got, want, rtol=1e-9, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_records_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_records_close(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def test_event_log_matches_reference_float64():
    want = _reference_log()
    sim, injector = _setup(sim_mod, inj, spec, reduction="torch", device="cpu")
    plane = ControlPlane(screening_backend="torch", fleet_kwargs={"device": "cpu"})
    got = _drive(plane, sim, injector, event_record)
    types = {r["type"] for r in want}
    assert {"Flag", "Diagnosis", "MitigationAction", "MitigationResult"} <= types
    _assert_records_close(got, want)


def _decisions(records):
    keep = ("Flag", "Diagnosis", "MitigationAction", "MitigationResult")
    out = []
    for r in records:
        if r["type"] not in keep:
            continue
        ev = r.get("event") or {}
        out.append((r["type"], r["time"], ev.get("root_cause"),
                    tuple(ev.get("components") or ()), r.get("strategy"),
                    r.get("kind"), r.get("status")))
    return out


@pytest.mark.parametrize("screen", ["cuda", "auto"])
def test_kernel_backends_on_cpu_decide_like_reference(screen):
    """``cuda``: the kernels' plain float32 versions on a CPU device;
    ``auto`` with ``device="cpu"``: the plain torch screen."""
    want = _decisions(_reference_log())
    sim, injector = _setup(
        sim_mod, inj, spec, reduction=sim_mod.CudaReduction(device="cpu"),
    )
    backend = (bocd.select_backend("cuda", device="cpu") if screen == "cuda"
               else "auto")
    plane = ControlPlane(screening_backend=backend,
                         fleet_kwargs={"device": "cpu"})
    got = _decisions(_drive(plane, sim, injector, event_record))
    assert got == want and want
