"""Dashboard renderer CLI — static HTML/SVG off a serialized campaign report;
the twin of the reference's ``launch/obs.py``.

    PYTHONPATH=src python -m repro_torch.launch.obs \
        --report build/repro_torch_results/campaigns/mixed_fleet-j8-s0.json \
        [--metrics build/repro_torch_results/campaigns/mixed_fleet-j8-s0.metrics.json] \
        [--out DIR/mixed_fleet-j8-s0.html]

Reads the scored report (and optionally the metrics sidecar) and writes a
standalone deterministic HTML page: per-job timeline lanes against the
injected ground truth, a host x time heat map of injected-vs-detected
faults, and the detect -> diagnose -> mitigate -> resolve funnel. The
output is a pure function of its inputs — identical files in, identical
bytes out — so dashboards can be committed and diffed like reports.

With no ``--metrics`` flag, the sidecar is picked up automatically when it
sits next to the report (``<base>.metrics.json``); ``--out`` defaults to
``<base>.html``.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.obs.dashboard import render_dashboard


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--report", required=True,
                    help="scored campaign report JSON")
    ap.add_argument("--metrics", default=None,
                    help="metrics sidecar (default: <base>.metrics.json "
                         "next to the report, when present)")
    ap.add_argument("--out", default=None,
                    help="output HTML path (default: <base>.html)")
    args = ap.parse_args()

    with open(args.report) as f:
        report = json.load(f)
    base, _ = os.path.splitext(args.report)
    metrics_path = args.metrics or f"{base}.metrics.json"
    metrics = None
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            metrics = json.load(f)
    out = args.out or f"{base}.html"
    html = render_dashboard(report, metrics)
    with open(out, "w") as f:
        f.write(html)
    print(f"dashboard: {out}")


if __name__ == "__main__":
    main()
