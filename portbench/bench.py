"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, ``portbench/traffic/<traffic>.json``,
whose ``driver`` key names the general driver ``portbench/drivers/<driver>.py``
that runs it. The cell's own limits on the numbers that decide ``correct``
are in ``portbench/cells/<workload>.json``. A per-layer metric is read by
``portbench/metrics/<name>.py``. A later cell, mix or metric is a new file
and a new entry; no file here changes. A later architecture is one new
file, ``portbench/reference/arch/<architecture>.py`` (what it holds:
``portbench/reference/arch/__init__.py``), and a configuration file whose
``architecture`` key names it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    #: the checkout whose files the cell was read from
    root: Path = ROOT


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = bench or benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench.get("per_layer", [])
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(
        name=name,
        chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((root / "portbench" / "cells" / f"{name}.json").read_text())["limits"],
        end_to_end=e2e,
        per_layer=per_layer,
        root=root,
    )


def driver(c: Cell):
    """The module that runs a cell's kind of traffic."""
    return importlib.import_module(f"portbench.drivers.{c.traffic['driver']}")


def reader(metric: str):
    """``read(ctx)`` of ``portbench/metrics/<metric>.py``: the metric's value
    from what a traced run gathered, or None where it finds nothing."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_metrics(c: Cell, ctx: dict) -> dict:
    """Every per-layer metric of ``c`` that its reader finds."""
    out = {}
    for m in c.per_layer:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is one that a run may not load
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
