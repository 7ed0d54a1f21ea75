"""Static dashboard renderer — deterministic HTML/SVG off a campaign report.

``render_dashboard(report)`` is a pure function of the scored report dict
(plus an optional metrics snapshot): no timestamps, no randomness, stable
iteration order, fixed rounding — the same report renders byte-identical
HTML, so a committed dashboard is diffable like any other artifact. The
CLI wrapper is ``python -m repro_torch.launch.obs``.

Three visuals, each an inline SVG:

* **Per-job timeline lanes** — one lane per job from join to completion
  (or the horizon), ground-truth fault windows as colored bands under it,
  onset diagnoses as triangles, applied mitigations as vertical ticks.
  The vertical offset between a band's left edge and its triangle IS the
  detection latency, visible without tooling.
* **Host x time heat map** — every injected episode drawn on its node
  row(s), green when some job's diagnosis traced back to it, red when it
  went undetected (the miss map).
* **Funnel** — detect (flags + watchdog alarms) -> diagnose (onsets) ->
  mitigate (applied dispatches) -> resolve (relief diagnoses), the
  pipeline's attrition at a glance.

Like :mod:`repro_torch.obs.recorder` this sits above the scenarios layer and is
imported explicitly, not via ``repro_torch.obs``.
"""
from __future__ import annotations

__all__ = ["render_dashboard"]

#: fixed per-cause palette (fault kinds map through their cause bucket)
_COLORS = {
    "gpu_degradation": "#e6a23c",
    "network_congestion": "#7b68ee",
    "cpu_contention": "#4baea0",
    "unknown": "#9aa0a6",
    "mixed": "#9aa0a6",
}
_KIND_COLOR = {
    "gpu_slow": "#e6a23c",
    "gpu_hang": "#d9534f",
    "cpu_contention": "#4baea0",
    "nic_congestion": "#5bc0de",
    "link_congestion": "#7b68ee",
    "link_flap": "#b07cc6",
    "collective_hang": "#d9534f",
}
_LANE_H = 26
_PAD_L = 70
_PAD_R = 20


def _esc(s) -> str:
    return (
        str(s).replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
        .replace('"', "&quot;")
    )


def _f(v: float) -> str:
    """Fixed-precision SVG coordinate (determinism: no float repr drift)."""
    return f"{v:.2f}".rstrip("0").rstrip(".")


class _Svg:
    def __init__(self, width: float, height: float) -> None:
        self.w, self.h = width, height
        self.parts: list[str] = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{_f(width)}" '
            f'height="{_f(height)}" viewBox="0 0 {_f(width)} {_f(height)}" '
            'font-family="sans-serif" font-size="11">'
        ]

    def rect(self, x, y, w, h, fill, opacity=None, title=None) -> None:
        o = f' fill-opacity="{opacity}"' if opacity is not None else ""
        t = f"<title>{_esc(title)}</title>" if title else ""
        self.parts.append(
            f'<rect x="{_f(x)}" y="{_f(y)}" width="{_f(max(w, 1.0))}" '
            f'height="{_f(h)}" fill="{fill}"{o}>{t}</rect>'
            if t else
            f'<rect x="{_f(x)}" y="{_f(y)}" width="{_f(max(w, 1.0))}" '
            f'height="{_f(h)}" fill="{fill}"{o}/>'
        )

    def line(self, x1, y1, x2, y2, stroke, width=1.0) -> None:
        self.parts.append(
            f'<line x1="{_f(x1)}" y1="{_f(y1)}" x2="{_f(x2)}" y2="{_f(y2)}" '
            f'stroke="{stroke}" stroke-width="{_f(width)}"/>'
        )

    def text(self, x, y, s, anchor="start", fill="#333") -> None:
        self.parts.append(
            f'<text x="{_f(x)}" y="{_f(y)}" text-anchor="{anchor}" '
            f'fill="{fill}">{_esc(s)}</text>'
        )

    def tri(self, x, y, size, fill, title=None) -> None:
        pts = (
            f"{_f(x)},{_f(y - size)} {_f(x - size * 0.7)},{_f(y)} "
            f"{_f(x + size * 0.7)},{_f(y)}"
        )
        t = f"<title>{_esc(title)}</title>" if title else ""
        self.parts.append(f'<polygon points="{pts}" fill="{fill}">{t}</polygon>'
                          if t else f'<polygon points="{pts}" fill="{fill}"/>')

    def render(self) -> str:
        return "".join(self.parts) + "</svg>"


def _time_axis(svg: _Svg, x0, x1, y, horizon: float) -> None:
    svg.line(x0, y, x1, y, "#bbb")
    n_ticks = 6
    for i in range(n_ticks + 1):
        t = horizon * i / n_ticks
        x = x0 + (x1 - x0) * i / n_ticks
        svg.line(x, y, x, y + 4, "#bbb")
        svg.text(x, y + 16, f"{int(round(t))}s", anchor="middle", fill="#777")


def _timeline_svg(report: dict, width: float = 960.0) -> str:
    c = report["campaign"]
    horizon = c["max_ticks"] * c["tick_seconds"]
    jobs = report["jobs"]
    h = len(jobs) * _LANE_H + 40
    svg = _Svg(width, h)
    x0, x1 = _PAD_L, width - _PAD_R

    def sx(t: float) -> float:
        return x0 + (x1 - x0) * min(max(t, 0.0), horizon) / horizon

    diags_by_job: dict[str, list[dict]] = {}
    for d in report["diagnoses"]:
        diags_by_job.setdefault(d["job_id"], []).append(d)
    mits_by_job: dict[str, list[dict]] = {}
    resolved_by_job: dict[str, list[float]] = {}
    for rec in report["event_log"]:
        if (
            rec["type"] == "MitigationResult"
            and rec.get("kind") == "mitigate" and rec.get("applied")
        ):
            mits_by_job.setdefault(rec["job_id"], []).append(rec)
        elif rec["type"] == "Diagnosis" and rec.get("resolved"):
            resolved_by_job.setdefault(rec["job_id"], []).append(rec["time"])

    dt = c["tick_seconds"]
    for i, row in enumerate(jobs):
        y = 10 + i * _LANE_H
        jid = row["job_id"]
        join = row["join_tick"] * dt
        jct = row["jct_s"].get("falcon")
        end = join + jct if jct is not None else horizon
        svg.text(x0 - 8, y + 14, jid, anchor="end")
        # lifetime lane
        svg.rect(
            sx(join), y + 6, sx(end) - sx(join), 10, "#dfe7f0",
            title=f"{jid}: {_f(join)}s - {_f(end)}s",
        )
        # ground-truth fault bands
        for ep in row["ground_truth_ticks"]:
            a = ep["onset"] * dt
            b = horizon if ep["relief"] is None else ep["relief"] * dt
            svg.rect(
                sx(a), y + 17, sx(b) - sx(a), 5, "#d9534f", opacity="0.55",
                title=f"injected: {_f(a)}s - {_f(b)}s "
                      f"(severity {ep['severity']})",
            )
        # onset diagnoses
        for d in diags_by_job.get(jid, []):
            color = _COLORS.get(d["cause"], "#9aa0a6")
            svg.tri(
                sx(d["time_s"]), y + 6, 5, color,
                title=f"diagnosed {d['cause']} @ {_f(d['time_s'])}s "
                      f"({', '.join(d['components']) or 'no components'})",
            )
        # applied mitigations
        for m in mits_by_job.get(jid, []):
            svg.line(sx(m["time"]), y + 4, sx(m["time"]), y + 18, "#2c7a2c", 2)
        for t in resolved_by_job.get(jid, []):
            svg.line(sx(t), y + 4, sx(t), y + 18, "#888", 1)
    _time_axis(svg, x0, x1, 10 + len(jobs) * _LANE_H + 4, horizon)
    return svg.render()


def _heatmap_svg(report: dict, width: float = 960.0) -> str:
    c = report["campaign"]
    horizon = c["max_ticks"] * c["tick_seconds"]
    n_nodes = c["n_nodes"]
    gpn = c["gpus_per_node"]
    h = n_nodes * _LANE_H + 40
    svg = _Svg(width, h)
    x0, x1 = _PAD_L, width - _PAD_R

    def sx(t: float) -> float:
        return x0 + (x1 - x0) * min(max(t, 0.0), horizon) / horizon

    node_kinds = ("cpu_contention", "nic_congestion")
    for n in range(n_nodes):
        y = 10 + n * _LANE_H
        svg.text(x0 - 8, y + 14, f"n{n}", anchor="end")
        svg.rect(sx(0), y + 4, x1 - x0, _LANE_H - 8, "#f4f6f8")
    for inj in report["injections"]:
        if inj["kind"] in node_kinds:
            nodes = list(inj["target"])
        else:
            nodes = sorted({d // gpn for d in inj["target"]})
        detected = bool(inj["detected_by"])
        fill = "#3c9a5f" if detected else "#d9534f"
        a, b = inj["start_s"], inj["start_s"] + inj["duration_s"]
        for n in nodes:
            if not 0 <= n < n_nodes:
                continue
            y = 10 + n * _LANE_H
            svg.rect(
                sx(a), y + 4, sx(min(b, horizon)) - sx(a), _LANE_H - 8,
                fill, opacity="0.75",
                title=f"#{inj['id']} {inj['kind']} target={inj['target']} "
                      f"{_f(a)}s +{_f(inj['duration_s'])}s "
                      f"severity={inj['severity']} "
                      + ("detected by " + ",".join(inj["detected_by"])
                         if detected else "UNDETECTED"),
            )
    _time_axis(svg, x0, x1, 10 + n_nodes * _LANE_H + 4, horizon)
    return svg.render()


def _funnel_svg(report: dict, width: float = 480.0) -> str:
    counts = report["falcon_event_counts"]
    onsets = len(report["diagnoses"])
    resolved = sum(
        1 for r in report["event_log"]
        if r["type"] == "Diagnosis" and r.get("resolved")
    )
    applied = sum(
        1 for r in report["event_log"]
        if r["type"] == "MitigationResult"
        and r.get("kind") == "mitigate" and r.get("applied")
    )
    stages = [
        ("detect", counts.get("Flag", 0) + counts.get("WatchdogAlarm", 0)),
        ("diagnose", onsets),
        ("mitigate", applied),
        ("resolve", resolved),
    ]
    top = max((v for _, v in stages), default=0) or 1
    h = len(stages) * 34 + 10
    svg = _Svg(width, h)
    for i, (name, v) in enumerate(stages):
        y = 8 + i * 34
        w = (width - 200) * v / top
        svg.text(90, y + 15, name, anchor="end")
        svg.rect(100, y, w, 22, "#4878a8", title=f"{name}: {v}")
        svg.text(104 + w, y + 15, str(v))
    return svg.render()


def _metrics_table(metrics: dict) -> str:
    rows = []
    for g in metrics.get("gauges", []):
        labels = ",".join(f"{k}={v}" for k, v in sorted(g["labels"].items()))
        rows.append(
            f"<tr><td>{_esc(g['name'])}"
            + (f"{{{_esc(labels)}}}" if labels else "")
            + f"</td><td>{g['value']}</td></tr>"
        )
    if not rows:
        return ""
    return (
        "<h2>Headline gauges</h2><table><tr><th>metric</th><th>value</th>"
        "</tr>" + "".join(rows) + "</table>"
    )


def render_dashboard(report: dict, metrics: dict | None = None) -> str:
    """Render a scored campaign report into one standalone HTML page."""
    c = report["campaign"]
    mit = report["mitigation"]
    det = report["detection"]["overall"]
    headline = (
        f"slowdown mitigated {mit['slowdown_mitigated_pct']}% "
        f"(ckpt baseline {mit['slowdown_mitigated_ckpt_pct']}%), "
        f"precision {det['precision']}, recall {det['recall']}"
    )
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{_esc(c['preset'])} campaign dashboard</title>",
        "<style>body{font-family:sans-serif;margin:24px;color:#222}"
        "h1{font-size:20px}h2{font-size:15px;margin-top:28px}"
        "table{border-collapse:collapse;font-size:12px}"
        "td,th{border:1px solid #ccc;padding:3px 8px;text-align:left}"
        ".legend{font-size:12px;color:#555;margin:4px 0 12px}"
        "</style></head><body>",
        f"<h1>{_esc(c['preset'])} — j{c['n_jobs']} s{c['seed']} "
        f"({c['n_nodes']} nodes x {c['gpus_per_node']} GPUs)</h1>",
        f"<p>{_esc(c['description'])}</p>",
        f"<p><b>{_esc(headline)}</b></p>",
        "<h2>Per-job timelines (falcon run)</h2>",
        "<div class='legend'>lane = job lifetime; red band = injected "
        "fault window (ground truth); triangle = onset diagnosis; green "
        "tick = applied mitigation; grey tick = relief</div>",
        _timeline_svg(report),
        "<h2>Host x time — injected vs detected</h2>",
        "<div class='legend'>green = episode traced back by some job's "
        "diagnosis; red = undetected</div>",
        _heatmap_svg(report),
        "<h2>Pipeline funnel</h2>",
        _funnel_svg(report),
    ]
    if metrics is not None:
        parts.append(_metrics_table(metrics))
    parts.append("</body></html>")
    return "\n".join(parts) + "\n"
