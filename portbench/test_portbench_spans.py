"""The per-layer metrics of the port's spans: each reader's value from a
fabricated record, and none from an empty record, from another driver's
run, or from a port without the spans."""
import sys

import pytest

from portbench import bench


def _t(count, host_s, device_s=None):
    return {"count": count, "host_s": host_s, "self_s": host_s, "device_s": device_s}


TRAIN = {"train.step": _t(2, 4.0), "train.compute": _t(2, 3.6, 3.2),
         "train.optimizer": _t(2, 0.5, 0.4), "falcon.model": _t(2, 0.006),
         "falcon.observe": _t(2, 0.014)}
SERVE = {"serve.batch": _t(1, 17.0), "serve.prefill": _t(1, 9.6, 9.5),
         "serve.decode": _t(128, 6.4), "serve.dispatch": _t(128, 5.12),
         "falcon.observe": _t(128, 0.064)}

CASES = [
    ("falcon_ms.train", "train", TRAIN, 10.0),
    ("falcon_ms.ssm_train", "train", TRAIN, 10.0),
    ("optimizer_pct.train", "train", TRAIN, 12.5),
    ("optimizer_pct.ssm_train", "train", TRAIN, 12.5),
    ("falcon_ms.serve", "serve", SERVE, 0.5),
    ("prefill_ms.serve", "serve", SERVE, 9500.0),
    ("decode_dispatch_ms.serve", "serve", SERVE, 40.0),
]


def _record(monkeypatch, record):
    from repro_torch.obs import runtime

    monkeypatch.setattr(runtime, "totals", lambda: record)


@pytest.mark.parametrize("name,driver,record,want", CASES)
def test_span_reader_reads_a_fabricated_record(name, driver, record, want, monkeypatch):
    _record(monkeypatch, record)
    assert bench.reader(name)({"driver": driver}) == pytest.approx(want, rel=1e-12)
    other = "serve" if driver == "train" else "train"
    assert bench.reader(name)({"driver": other}) is None


@pytest.mark.parametrize("name,driver", [c[:2] for c in CASES])
def test_span_reader_finds_nothing_in_an_empty_record(name, driver, monkeypatch):
    _record(monkeypatch, {})
    assert bench.reader(name)({"driver": driver}) is None


@pytest.mark.parametrize("name,driver", [c[:2] for c in CASES])
def test_span_reader_finds_nothing_without_the_ports_spans(name, driver, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs.runtime", None)
    assert bench.reader(name)({"driver": driver}) is None


def test_device_readers_find_nothing_in_a_cpu_record(monkeypatch):
    for record, device_reader, host_reader, driver, want in (
            (TRAIN, "optimizer_pct.train", "falcon_ms.train", "train", 10.0),
            (SERVE, "prefill_ms.serve", "decode_dispatch_ms.serve", "serve", 40.0)):
        _record(monkeypatch, {k: dict(v, device_s=None) for k, v in record.items()})
        assert bench.reader(device_reader)({"driver": driver}) is None
        assert bench.reader(host_reader)({"driver": driver}) == pytest.approx(want)


def test_span_metrics_are_listed_for_their_cells():
    b = bench.benchmark()
    new = {m["name"]: m for m in b["per_layer"] if m["source"] == "program_span"}
    for name, driver, _, _ in CASES:
        m = new[name]
        for w in m["workloads"]:
            c = bench.cell(w, b)
            assert c.traffic["driver"] == driver and m in c.per_layer
