"""What the drivers share: the port's configuration from a file, the
result line's device entry."""
from __future__ import annotations

import dataclasses
import sys

import torch


def port_config(conf: dict, sz: dict):
    """The port's ``ArchConfig`` of configuration file ``conf``, every size
    taken from the file, the architecture's own through its module."""
    from repro_torch.configs.base import SubLayer, get_config

    fields = {"num_layers": sz["layers"], "d_model": sz["d"], "vocab_size": sz["vocab"],
              "norm_eps": sz["eps"], **sz["arch"].port_fields(sz)}
    fields["period"] = tuple(SubLayer(mixer, mlp) for mixer, mlp in fields["period"])
    return dataclasses.replace(get_config(conf["port_arch"]), **fields)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def device_entry(device: torch.device, chips: int, peak_bytes: int) -> dict:
    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": chips, "memory_peak_bytes": peak_bytes}


def end_to_end(cell, setup_s: float, rate: float) -> dict:
    """The result's ``metrics`` of an untraced run: ``setup_s``, and the
    window's rate under the cell's one other end-to-end metric."""
    others = [m["name"] for m in cell.end_to_end if m["name"] != "setup_s"]
    if len(others) != 1:
        raise ValueError(f"cell {cell.name} reports {others} beside setup_s; its driver gives one rate")
    values = {"setup_s": setup_s, others[0]: rate}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def finish(out: dict, traced: dict | None, checks: dict) -> dict:
    """The traced run's device seconds and breakdown, then ``checks`` last."""
    if traced is not None:
        out["device"]["busy_s"] = traced["busy_s"]
        out["device"]["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    out["checks"] = checks
    return out


def print_split(t0: float, marks) -> None:
    """The set-up's phases, to standard error: each mark's seconds since the
    one before it, the first since ``t0``."""
    prev, parts = t0, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    print("set-up split (s):", ", ".join(parts), file=sys.stderr)
