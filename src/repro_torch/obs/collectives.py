"""Per-collective timing decomposition of a simulated training iteration.

The simulator's iteration-time formula (docs/simulator.md) is a max/sum
over per-cell reductions; this module re-reads those cached reductions
(:class:`~repro_torch.cluster.simulator._Cells`) and splits the *critical path*
into its four constituents:

* **compute** — the critical DP column's slowest stage, compute part,
  times the pipeline multiplier ``m_d + P - 1``;
* **tp_allreduce** — the same stage's TP ring all-reduce, same multiplier;
* **pp_p2p** — the critical column's activation-hop round trips;
* **dp_allreduce** — the gradient all-reduce of the slowest DP ring.

That turns "job J is slow" into "the DP all-reduce of ring ``dp:s0t0``
over ring edge ``link:0-4`` is the bottleneck" — the CCL-D-style
stream-level attribution ROADMAP item 5a left open. The control plane
attaches a :class:`CollectiveBreakdown` to every onset Diagnosis (see
``docs/observability.md`` for the decomposition contract), so a
``COLLECTIVE_HANG`` or link fault is pinned to the specific collective and
ring edge, not just the job.

This module is a leaf: it imports nothing from the cluster or control
plane layers (the simulator imports *it*), and reads the simulator
duck-typed through its cached-cell surface.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: decomposition component names, in reporting order
COMPONENTS = ("compute", "tp_allreduce", "pp_p2p", "dp_allreduce")


@dataclass(frozen=True)
class CollectiveBreakdown:
    """One iteration's critical-path time split, with the bottleneck named.

    ``bottleneck`` is the largest of the four components; ``group`` its
    profiling-group key in the simulator's naming scheme (``tp:s{s}d{d}``,
    ``dp:s{s}t{k}``, ``pp:d{d}``) and ``edge`` the slowest constituent —
    a ring edge ``link:a-b`` (local device ranks, the same ids the
    detector's component validation emits) or, for a compute bottleneck,
    the slowest device ``gpu:r``. ``share`` is the bottleneck's fraction
    of ``total_s``.
    """

    compute_s: float
    tp_allreduce_s: float
    pp_p2p_s: float
    dp_allreduce_s: float
    total_s: float
    bottleneck: str
    group: str
    edge: str
    share: float

    def parts(self) -> dict[str, float]:
        return {
            "compute": self.compute_s,
            "tp_allreduce": self.tp_allreduce_s,
            "pp_p2p": self.pp_p2p_s,
            "dp_allreduce": self.dp_allreduce_s,
        }

    def summary(self) -> dict:
        """Compact rounded view for trace span args / metric labels."""
        return {
            "bottleneck": self.bottleneck,
            "group": self.group,
            "edge": self.edge,
            "share": round(self.share, 4),
            "total_s": round(self.total_s, 6),
        }


def _link(a: int, b: int) -> str:
    lo, hi = sorted((int(a), int(b)))
    return f"link:{lo}-{hi}"


def decompose(sim) -> CollectiveBreakdown:
    """Critical-path decomposition of ``sim``'s current iteration time.

    Reads the cached per-cell reductions (no extra state traversal: the
    call after an ``iteration_time()`` costs O(cells) argmax/argmin work)
    and names the bottleneck collective, its profiling group, and the
    slowest ring edge / device inside it.
    """
    job = sim.job
    c = sim._cells()
    lay = sim._layout()
    grid = lay.grid
    # Critical DP column: the argmax of the pipeline formula, exactly as
    # iteration_time() evaluates it.
    pipe = sim._alloc_off() * c.stage_max
    if c.hop_bw is not None:
        pipe = pipe + c.hop2
    d = int(np.argmax(pipe))
    s = int(np.argmax(c.stage[:, d]))
    n = float(sim._alloc_off()[d])

    compute_s = n * float(c.c_flops / (c.c_speed * c.cell_speed[s, d]))
    tp_s = (
        n * float(c.c_tp / c.tp_bw[s, d]) if c.tp_bw is not None else 0.0
    )
    pp_s = float(c.hop2[d]) if c.hop_bw is not None else 0.0
    dp_s = float(c.c_dp / c.dp_bw.min()) if c.dp_bw is not None else 0.0
    total = float(sim.iteration_time())

    parts = {
        "compute": compute_s,
        "tp_allreduce": tp_s,
        "pp_p2p": pp_s,
        "dp_allreduce": dp_s,
    }
    # First-wins on exact ties: dict order is the fixed COMPONENTS order,
    # so the pick is deterministic.
    bottleneck = max(parts.items(), key=lambda kv: kv[1])[0]

    if bottleneck == "dp_allreduce":
        flat = int(np.argmin(c.dp_bw))
        s2, k2 = divmod(flat, job.tp)
        d2 = int(np.argmin(c.dp_edge[s2, :, k2]))
        group = f"dp:s{s2}t{k2}"
        edge = _link(grid[s2, d2, k2], grid[s2, (d2 + 1) % job.dp, k2])
    elif bottleneck == "tp_allreduce":
        k2 = int(np.argmin(c.tp_edge[s, d]))
        group = f"tp:s{s}d{d}"
        edge = _link(grid[s, d, k2], grid[s, d, (k2 + 1) % job.tp])
    elif bottleneck == "pp_p2p":
        hs = int(np.argmin(c.hop_bw[:, d]))
        group = f"pp:d{d}"
        edge = _link(grid[hs, d, 0], grid[hs + 1, d, 0])
    else:  # compute
        row = grid[s, d]
        speeds = sim.state._compute[row] * sim.state._host[row]
        group = f"tp:s{s}d{d}"
        edge = f"gpu:{int(row[int(np.argmin(speeds))])}"

    return CollectiveBreakdown(
        compute_s=compute_s,
        tp_allreduce_s=tp_s,
        pp_p2p_s=pp_s,
        dp_allreduce_s=dp_s,
        total_s=total,
        bottleneck=bottleneck,
        group=group,
        edge=edge,
        share=parts[bottleneck] / total if total > 0 else 0.0,
    )


def timing_decomposition(sim) -> dict[str, list]:
    """Every cell's time split, as nested lists (the per-cell contract).

    * ``compute_s[s][d]`` / ``tp_allreduce_s[s][d]`` — one micro-batch's
      compute / TP-ring time of TP cell (stage ``s``, dp rank ``d``);
    * ``pp_p2p_s[h][d]`` — the round-trip activation hop between stages
      ``h`` and ``h+1`` of DP column ``d`` (empty when ``pp == 1``);
    * ``dp_allreduce_s[s][k]`` — the full gradient all-reduce of DP ring
      (stage ``s``, tp rank ``k``) (empty when ``dp == 1``).

    ``dp_allreduce_s`` matches ``profile_groups()``'s ``dp:*`` entries and
    ``tp_allreduce_s`` its ``tp:*`` entries bit for bit (same cached
    arrays, same arithmetic) — the equivalence the decomposition tests pin.
    """
    c = sim._cells()
    compute = c.c_flops / (c.c_speed * c.cell_speed)
    out: dict[str, list] = {
        "compute_s": compute.tolist(),
        "tp_allreduce_s": (
            (c.c_tp / c.tp_bw).tolist()
            if c.tp_bw is not None else np.zeros_like(compute).tolist()
        ),
        "pp_p2p_s": (
            (2.0 * c.pp_vol / c.hop_bw).tolist()
            if c.hop_bw is not None else []
        ),
        "dp_allreduce_s": (
            (c.c_dp / c.dp_bw).tolist() if c.dp_bw is not None else []
        ),
    }
    return out
