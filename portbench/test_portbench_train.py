"""The comparison that decides ``correct`` in the training cells, at a size
the CPU holds: the plain reference agrees with the port, the control (the
reference in fp8 in the port's place) and a run whose step or FALCON is
broken underneath come out not correct, and a run's last line has the
result's keys."""
import dataclasses
import time

import pytest
import torch

from portbench import bench
from portbench.drivers import train
from portbench.reference import train as ref_train

WORKLOADS = bench.benchmark()["workloads"]
CELLS = [w["name"] for w in WORKLOADS if bench.cell(w["name"]).traffic["driver"] == "train"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name, small):
    c = small(name)
    r = train.Run(c, 2**31 + 17, "cpu")
    first = r.first
    r.free()
    gaps = ref_train.compare(first, r.reference())
    assert all(gaps[k] <= lim for k, lim in c.limits.items() if k in gaps), (gaps, c.limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, small):
    """The reference in fp8, put in the port's place, fails a limit."""
    c = small(name)
    r = train.Run(c, 2**31 + 23, "cpu")
    r.free()
    want = r.reference()
    gaps = ref_train.compare(r.reference(precision="fp8"), want)
    assert any(gaps[k] > lim for k, lim in c.limits.items() if k in gaps), (gaps, c.limits)


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_result_keys(trace, small):
    c = small(CELLS[0])
    out = train.run(c, 2**31 + 5, 0.5, bool(trace), "cpu", time.perf_counter())
    want = KEYS + ["events"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    names = [m["name"] for m in (c.per_layer if trace else c.end_to_end)]
    assert set(out["metrics"]) <= set(names)
    if not trace:
        assert set(out["metrics"]) == set(names)
    assert set(out["checks"]) == set(c.limits)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["events"]["Observation"] == (out["attempted"] + c.traffic["setup_steps"]
                                            + (c.traffic["trace_steps"] if trace else 0))


def _unchanged(trainer):
    """The step computes its loss and returns its state unchanged."""
    from repro_torch.models import model as model_lib

    def step(params, opt_state, batch):
        with torch.no_grad():
            loss = sum(model_lib.loss_fn(params, {k: v[i] for k, v in batch.items()},
                                         trainer.cfg)[0] for i in range(trainer.data.slots))
        return params, opt_state, {"loss": loss / trainer.data.slots}

    trainer._step_fn = step


def _half_batch(trainer):
    """The step takes the mean over the first half of the slots only."""
    real = trainer._step_fn

    def step(params, opt_state, batch):
        return real(params, opt_state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    trainer._step_fn = step


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_step_is_not_correct(name, fault, small):
    out = train.run(small(name), 2**31 + 29, 0.2, False, "cpu", time.perf_counter(), plant=fault)
    assert out["correct"] is False, out["checks"]


def _observe_skipped(trainer):
    """FALCON is not fed: the step never reaches ``observe``."""
    trainer.falcon_enabled = False


def _wrong_gpu(trainer):
    """The pinpoint names the slow GPU's neighbour."""
    det = trainer._job.detector
    real = det.observe

    def observe(iter_time, now):
        ev = real(iter_time, now)
        if ev is not None:
            n = int(ev.components[0].split(":")[1]) + 1
            ev = dataclasses.replace(ev, components=[f"gpu:{n}"])
        return ev

    det.observe = observe


@pytest.mark.parametrize("fault", [_observe_skipped, _wrong_gpu])
def test_a_broken_falcon_is_not_correct(fault, small):
    """Set-up's steps alone carry the modelled clock past the diagnosis's
    deadline, whatever the host's speed."""
    c = small(CELLS[0])
    c.traffic = dict(c.traffic, setup_steps=c.traffic["expect"]["diagnosis_within"] + 8)
    out = train.run(c, 2**31 + 47, 0.2, False, "cpu", time.perf_counter(), plant=fault)
    assert out["checks"]["event_mismatches"]["value"] > 0
    assert out["correct"] is False, out["checks"]
