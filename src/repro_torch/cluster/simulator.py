"""Hybrid-parallel training-iteration performance model.

Models one training job under (TP, DP, PP) hybrid parallelism on a
:class:`ClusterState`, with 1F1B pipelining, ring collectives, per-DP-group
micro-batch counts (S2), and a logical->physical placement permutation (S3).
It implements the :class:`repro_torch.core.detector.ClusterInterface` protocol so
FALCON-DETECT runs against it unchanged, and emits the same CommEvent
stream the Monitor shim would log on a real job.

The model intentionally follows the paper's own cost reasoning
(Appendix 9.2): compute time = FLOPs / effective speed; collective time =
ring volume / slowest link; pipeline time = (m + P - 1) x slowest stage.

Fast-path architecture (fleet scale)
------------------------------------
``iteration_time()`` / ``profile_groups()`` / ``per_microbatch_times()``
run on a vectorized core instead of the original nested Python loops:

* A per-placement :class:`_Layout` precomputes the (pp, dp, tp) device-index
  grid, the ring-edge endpoint arrays of every TP cell and DP ring, the PP
  hop endpoints and the profiling-group key strings. It is rebuilt only when
  the placement (or job/cluster) changes.
* Per-cell partial reductions are cached in :class:`_Cells` (cell speed
  minima, per-edge ring bandwidths and their ring minima, hop bandwidths,
  derived stage times) aligned with the ``_Layout`` index tensors.
* Invalidation is *event-scoped*: the simulator holds a cursor into its
  :class:`~repro_torch.cluster.spec.ClusterState`'s typed mutation log and
  re-reduces only what a :class:`~repro_torch.cluster.spec.DirtySet` touches —
  device dirt refreshes one cell's speed/stage, link dirt only the ring/hop
  edges that traverse that link, NIC dirt the port's cross-node incident
  edges, and ``remap_groups`` only the cells whose membership changed.
  A single fail-slow event therefore costs O(dirty cells), not O(devices);
  see docs/simulator.md for the full contract.
* Results are memoized on top: ``ClusterState.version`` covers every health
  mutation (device-speed writes, link/NIC multiplier changes, ``reset``),
  and the simulator bumps an internal config version whenever
  ``placement``/``allocation``/``state`` are reassigned (including through
  ``set_allocation``/``apply_placement``/``restart``). Healthy steps
  between fail-slow events therefore cost O(1); mutate state only through
  those surfaces (lists must be *reassigned*, not edited in place).
  Reassigning ``placement``/``state``/``job``/``cluster`` wholesale drops
  the cell cache (full rebuild on next evaluation — the pre-refactor cost);
  ``sim.incremental = False`` forces that mode permanently (benchmarks).

The original loop implementations remain as ``*_reference()`` methods; the
fast path matches them bit for bit (equivalence-tested), so benchmark
results are unchanged at lower wall-clock.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.events import CommEvent, CommOp
from repro_torch.device import resolve_device
from repro_torch.kernels.cell_reduce import cell_reduce, cell_reduce_reference
from repro_torch.core.topology import HybridTopology
from repro_torch.cluster.spec import ClusterSpec, ClusterState, DirtySet, ModelSpec
from repro_torch.obs.collectives import CollectiveBreakdown, decompose, timing_decomposition


@dataclass
class JobSpec:
    """One hybrid-parallel training job."""

    model: ModelSpec
    tp: int
    dp: int
    pp: int
    micro_batches: int  # M, per iteration (global batch / micro-batch size)

    @property
    def topology(self) -> HybridTopology:
        return HybridTopology(tp=self.tp, dp=self.dp, pp=self.pp)

    @property
    def n_devices(self) -> int:
        return self.tp * self.dp * self.pp


class _Layout:
    """Placement-derived index tensors, built once per placement.

    ``grid[s, d, k]`` is the physical device at (stage, dp_rank, tp_rank);
    the flattened ring-edge endpoint arrays feed ``link_bw_many`` gathers.
    """

    def __init__(self, placement: list[int], job: JobSpec) -> None:
        self.tp_keys = [
            f"tp:s{s}d{d}" for s in range(job.pp) for d in range(job.dp)
        ]
        self.dp_keys = [
            f"dp:s{s}t{k}" for s in range(job.pp) for k in range(job.tp)
        ]
        self.update(placement, job)

    def update(self, placement: list[int], job: JobSpec) -> None:
        """Refresh the index tensors for a new placement *in place*.

        The incremental rebuild path for :meth:`TrainingSimulator.
        remap_groups`: the group-key strings (the expensive part of a full
        build, and placement-independent) survive; only the device grid and
        the ring/hop endpoint gathers are recomputed — O(devices) array
        work with no Python-level string formatting.
        """
        flat = np.asarray(placement, dtype=np.int64)
        grid = flat.reshape(job.pp, job.dp, job.tp)
        self.grid = grid
        #: inverse index: physical device -> flat logical position (-1 =
        #: device not used by this job); dirty components map through it to
        #: the (stage, dp, tp) cells incremental recomputation must touch
        self.dev_pos = np.full(int(flat.max()) + 1, -1, dtype=np.int64)
        self.dev_pos[flat] = np.arange(flat.size, dtype=np.int64)
        self.tp_edges = None
        self.dp_edges = None
        self.hop_edges = None
        if job.tp > 1:
            self.tp_edges = (
                grid.reshape(-1), np.roll(grid, -1, axis=2).reshape(-1)
            )
        if job.dp > 1:
            self.dp_edges = (
                grid.reshape(-1), np.roll(grid, -1, axis=1).reshape(-1)
            )
        if job.pp > 1:
            self.hop_edges = (
                grid[:-1, :, 0].reshape(-1), grid[1:, :, 0].reshape(-1)
            )
        #: lazy node -> incident cross-node edge index per edge class,
        #: built on the first NIC-scoped dirty update for this placement
        self.nic_index = None
        #: lazy node -> :class:`_NodeNic` (per-node precomputed incidence:
        #: fused endpoint gathers, ring groupings, touched cells/columns),
        #: so a repeat NIC event on a node costs zero index arithmetic
        self.nic_cache: dict = {}

    def build_nic_index(self, per: int) -> dict:
        """node -> flat ids of the cross-node edges touching it, per edge
        class (sorted-by-node arrays for searchsorted range queries)."""

        def index(edges):
            if edges is None:
                return None
            a, b = edges
            na = a // per
            nb = b // per
            cross = np.flatnonzero(na != nb)
            nodes = np.concatenate([na[cross], nb[cross]])
            ids = np.concatenate([cross, cross])
            order = np.argsort(nodes, kind="stable")
            return nodes[order], ids[order]

        self.nic_index = {
            "tp": index(self.tp_edges),
            "dp": index(self.dp_edges),
            "hop": index(self.hop_edges),
        }
        return self.nic_index

    def node_nic(self, node: int, per: int) -> "_NodeNic | None":
        """The node's precomputed NIC-dirt incidence (None when no cached
        edge crosses it), built once per (placement, node) and memoized —
        the per-event NIC path then does no searchsorted/unique work."""
        ent = self.nic_cache.get(node, False)
        if ent is not False:
            return ent
        idx = self.nic_index or self.build_nic_index(per)
        pp, dp, tp = self.grid.shape
        span = dp * tp
        seg_a: list[np.ndarray] = []
        seg_b: list[np.ndarray] = []

        def ids_of(cls, edges):
            pair = idx[cls]
            if pair is None:
                return None
            nodes_arr, eids = pair
            lo = np.searchsorted(nodes_arr, node)
            hi = np.searchsorted(nodes_arr, node + 1)
            if lo == hi:
                return None
            ids = eids[lo:hi].copy()
            seg_a.append(edges[0][ids])
            seg_b.append(edges[1][ids])
            return ids

        tp_ids = ids_of("tp", self.tp_edges)
        dp_ids = ids_of("dp", self.dp_edges)
        hop_ids = ids_of("hop", self.hop_edges)
        if tp_ids is None and dp_ids is None and hop_ids is None:
            self.nic_cache[node] = None
            return None
        ent = _NodeNic()
        ent.a = np.concatenate(seg_a)
        ent.b = np.concatenate(seg_b)
        n_tp = 0 if tp_ids is None else tp_ids.size
        n_dp = 0 if dp_ids is None else dp_ids.size
        ent.off_dp = n_tp
        ent.off_hop = n_tp + n_dp
        ent.tp_ids = tp_ids
        ent.dp_ids = dp_ids
        ent.hop_ids = hop_ids
        if tp_ids is not None:
            cf = np.unique(tp_ids // tp)
            ent.tp_cells = list(zip((cf // dp).tolist(), (cf % dp).tolist()))
        if hop_ids is not None:
            ent.hop_cols = np.unique(hop_ids % dp).tolist()
        if dp_ids is not None:
            # Group the node's DP edges by ring (stage, tp_rank): the
            # argmin fast path compares each touched ring's candidate
            # minimum against the cached bottleneck in O(touched edges).
            rings = (dp_ids // span) * tp + dp_ids % tp
            order = np.argsort(rings, kind="stable")
            rsorted = rings[order]
            starts = np.flatnonzero(
                np.r_[True, rsorted[1:] != rsorted[:-1]]
            )
            uniq = rsorted[starts]
            widths = np.diff(np.r_[starts, rings.size])
            ent.ring_s = uniq // tp
            ent.ring_k = uniq % tp
            ent.dp_order = order
            dpos = (dp_ids // tp) % dp  # edge position within its ring
            w = int(widths.max())
            ent.uniform = bool(widths.min() == w)
            if ent.uniform:
                ent.dp_width = w
                ent.dp_dpos2 = dpos[order].reshape(uniq.size, w)
                ent.dp_rows = np.arange(uniq.size)
        self.nic_cache[node] = ent
        return ent


class _NodeNic:
    """Per-(placement, node) NIC-dirt incidence (see ``_Layout.node_nic``).

    ``a``/``b`` are the fused endpoint arrays of every cached cross-node
    edge touching the node, ordered [tp | dp | hop] with class offsets
    ``off_dp``/``off_hop``, so one ``link_bw_many`` call re-measures them
    all. The dp fields group the node's DP-ring edges by ring for the
    argmin fast path (``uniform`` marks equal edges-per-ring, the common
    topology, enabling the reshaped vectorized compare)."""

    __slots__ = (
        "a", "b", "off_dp", "off_hop", "tp_ids", "dp_ids", "hop_ids",
        "tp_cells", "hop_cols", "ring_s", "ring_k", "dp_order", "uniform",
        "dp_width", "dp_dpos2", "dp_rows",
    )

    def __init__(self) -> None:
        self.tp_ids = self.dp_ids = self.hop_ids = None
        self.tp_cells: list = []
        self.hop_cols: list = []
        self.uniform = False


class _Cells:
    """Per-cell partial reductions over the current placement and state.

    ``cell_speed[s, d]`` is the slowest effective device speed of TP cell
    (stage, dp_rank); ``tp_edge``/``dp_edge`` hold every ring edge's
    bandwidth (shape ``(pp, dp, tp)``; edge ``k`` of a TP cell connects tp
    ranks ``k -> k+1``, edge ``d`` of a DP ring connects dp ranks
    ``d -> d+1``), with ``tp_bw``/``dp_bw`` their per-cell / per-ring
    minima; ``hop_bw[s, d]`` the stage-``s``→``s+1`` activation-hop
    bandwidth of DP rank ``d``; ``stage[s, d]`` the derived one-micro-batch
    stage time. These are exactly the O(devices) gather+reduce products of
    the vectorized pass — everything downstream is O(cells). A
    :class:`~repro_torch.cluster.spec.DirtySet` maps through the layout's inverse
    index to positions, then to the incident edges and containing
    cells/rings, so a fail-slow event re-reduces only what it touches (see
    docs/simulator.md).
    """

    __slots__ = (
        "cell_speed", "tp_edge", "tp_bw", "dp_edge", "dp_bw", "hop_bw",
        "stage", "stage_max", "hop2",
        # lazy per-ring argmin over the DP axis, shape (pp, tp): dp_arg[s,k]
        # is the ring position attaining dp_bw[s,k], -1 = unknown. Built on
        # demand by the NIC fast path (None until then) and *invalidated*,
        # not maintained, by the other update paths, so they pay nothing.
        "dp_arg",
        # job-constant formula terms, factored once per build so the scalar
        # update paths replay the exact arithmetic of the array formulas
        "c_flops", "c_speed", "c_tp", "pp_vol", "c_dp",
    )


@dataclass
class TrainingSimulator:
    """Iteration-time model + FALCON ClusterInterface implementation."""

    #: event-scoped invalidation switch (class-level; set ``sim.incremental
    #: = False`` to force the pre-dirty-set behavior of one full vectorized
    #: recompute per state mutation — kept for benchmarking the two paths)
    incremental = True

    cluster: ClusterSpec
    job: JobSpec
    #: logical position p (HybridTopology order) -> physical device perm[p]
    placement: list[int] = field(default_factory=list)
    #: per-DP-group micro-batch counts (S2); default: even split
    allocation: list[int] = field(default_factory=list)
    #: reduction backend: "auto" (the CUDA kernel on the card, raising when
    #: there is none; the plain torch version when ``device`` is the CPU), a
    #: registry name ("reference" / "vectorized" / "torch" / "cuda"), or a
    #: ReductionBackend instance — see REDUCTION_BACKENDS
    reduction: object = "auto"
    #: torch device of the ``torch``/``cuda``/``auto`` reductions (None =
    #: the card); the numpy backends ignore it
    device: object = None
    state: ClusterState = field(init=False)

    def __post_init__(self) -> None:
        if self.job.n_devices > self.cluster.n_devices:
            raise ValueError("job does not fit on the cluster")
        if not self.placement:
            self.placement = list(range(self.job.n_devices))
        if not self.allocation:
            base, extra = divmod(self.job.micro_batches, self.job.dp)
            self.allocation = [
                base + (1 if i < extra else 0) for i in range(self.job.dp)
            ]
        self.state = ClusterState(self.cluster)

    # ------------------------------------------------- memo bookkeeping
    def __setattr__(self, name: str, value) -> None:
        object.__setattr__(self, name, value)
        d = self.__dict__
        if name in ("placement", "job", "cluster"):
            d["_place_ver"] = d.get("_place_ver", 0) + 1
        if name in ("placement", "allocation", "state", "job", "cluster",
                    "reduction", "device"):
            d["_cfg_ver"] = d.get("_cfg_ver", 0) + 1
        if name in ("reduction", "device"):
            d["_red_obj"] = False  # unresolved; None = inline vectorized
        if name in ("allocation", "job"):
            d["_alloc_arr"] = None  # caches allocation + pp - 1
        if name in ("job", "cluster"):
            d["_healthy_cache"] = None  # healthy time depends only on these

    def _layout(self) -> _Layout:
        d = self.__dict__
        if d.get("_layout_ver") != d["_place_ver"]:
            d["_layout_cache"] = _Layout(self.placement, self.job)
            d["_layout_ver"] = d["_place_ver"]
        return d["_layout_cache"]

    # ------------------------------------------------------------- layout
    def device_at(self, stage: int, dp_rank: int, tp_rank: int) -> int:
        return self.placement[self.job.topology.position(stage, dp_rank, tp_rank)]

    def _cell_devices(self, stage: int, dp_rank: int) -> list[int]:
        return [self.device_at(stage, dp_rank, k) for k in range(self.job.tp)]

    # --------------------------------------------- vectorized fast path
    def _stage_from(self, cell_speed, tp_bw):
        """The (pp, dp)-shaped stage-time formula — one chain of elementwise
        ops, applied identically to the full arrays (rebuild) and to dirty
        sub-slices (incremental update), so both paths agree bit for bit."""
        m = self.job.model
        compute = (
            m.flops_per_microbatch() / self.job.pp
        ) / (self.job.tp * self.cluster.gpu_flops * cell_speed)
        if tp_bw is not None:
            tp_vol = m.comm_tp_bytes(self.job.tp, self.job.pp, 1)
            compute += 2.0 * (self.job.tp - 1) / self.job.tp * tp_vol / tp_bw
        return compute

    def _cells_rebuild(self, lay: _Layout) -> _Cells:
        """Full vectorized pass: every per-cell reduction from scratch."""
        state = self.state
        job = self.job
        m = job.model
        pp, dp, tp = job.pp, job.dp, job.tp
        c = _Cells()
        c.cell_speed = state.effective_speeds()[lay.grid].min(axis=2)
        c.tp_edge = c.tp_bw = c.dp_edge = c.dp_bw = c.hop_bw = None
        if lay.tp_edges is not None:
            c.tp_edge = state.link_bw_many(*lay.tp_edges).reshape(pp, dp, tp)
            c.tp_bw = c.tp_edge.min(axis=2)
        if lay.dp_edges is not None:
            c.dp_edge = state.link_bw_many(*lay.dp_edges).reshape(pp, dp, tp)
            c.dp_bw = c.dp_edge.min(axis=1)
        c.dp_arg = None
        if lay.hop_edges is not None:
            c.hop_bw = state.link_bw_many(*lay.hop_edges).reshape(pp - 1, dp)
        c.stage = self._stage_from(c.cell_speed, c.tp_bw)
        c.stage_max = c.stage.max(axis=0)
        # Factored formula terms: each is the exact left-to-right prefix of
        # the corresponding array expression, so the scalar update paths
        # reproduce the same float chains.
        c.c_flops = m.flops_per_microbatch() / pp
        c.c_speed = tp * self.cluster.gpu_flops
        c.c_tp = (
            2.0 * (tp - 1) / tp * m.comm_tp_bytes(tp, pp, 1)
            if c.tp_bw is not None else 0.0
        )
        c.pp_vol = m.comm_pp_bytes(1)
        c.c_dp = 2.0 * (dp - 1) / dp * m.comm_dp_bytes(tp, pp)
        c.hop2 = (
            0.0 if c.hop_bw is None
            else 2.0 * (c.pp_vol / c.hop_bw).sum(axis=0)
        )
        return c

    def _apply_dirty(self, cache: _Cells, lay: _Layout, ds) -> None:
        """Event-scoped cache refresh from a typed
        :class:`~repro_torch.cluster.spec.DirtySet`.

        Device dirt re-reduces only the containing cell's speed minimum and
        stage time (edge bandwidths do not depend on device speeds); link
        dirt re-measures only the cached ring/hop edges that actually
        traverse that physical link (a degraded link no ring uses costs
        nothing — the same observability rule the campaign's impact filter
        applies); NIC dirt re-measures the node's devices' incident
        *cross-node* edges (intra-node edges carry no NIC factor). All
        refreshed entries replay the full pass's exact operation chains.
        """
        state = self.state
        pp, dp, tp = self.job.pp, self.job.dp, self.job.tp
        grid = lay.grid
        dev_pos = lay.dev_pos
        span = dp * tp
        cell_dirty: set[tuple[int, int]] = set()   # cell_speed changed
        tp_e: set[tuple[int, int, int]] = set()
        dp_e: set[tuple[int, int, int]] = set()
        hop_e: set[tuple[int, int]] = set()

        def pos_of(dev: int) -> int | None:
            if 0 <= dev < dev_pos.size:
                p = dev_pos[dev]
                if p >= 0:
                    return int(p)
            return None

        for dev in ds.devices:
            p = pos_of(dev)
            if p is not None:
                s, r = divmod(p, span)
                cell_dirty.add((s, r // tp))
        for a, b in ds.links:
            pa, pb = pos_of(a), pos_of(b)
            if pa is None or pb is None:
                continue
            sa, ra = divmod(pa, span)
            sb, rb = divmod(pb, span)
            da, ka = divmod(ra, tp)
            db, kb = divmod(rb, tp)
            if sa == sb:
                if da == db and cache.tp_edge is not None:
                    if (ka + 1) % tp == kb:
                        tp_e.add((sa, da, ka))
                    if (kb + 1) % tp == ka:
                        tp_e.add((sa, da, kb))
                if ka == kb and cache.dp_edge is not None:
                    if (da + 1) % dp == db:
                        dp_e.add((sa, da, ka))
                    if (db + 1) % dp == da:
                        dp_e.add((sa, db, ka))
            elif (
                cache.hop_bw is not None
                and ka == 0 and kb == 0 and da == db
                and abs(sa - sb) == 1
            ):
                hop_e.add((min(sa, sb), da))
        tp_cells: set[tuple[int, int]] = set()
        dp_rings: set[tuple[int, int]] = set()
        hop_cols: set[int] = set()
        if ds.nics:
            # Node-scoped dirt: every incident cross-node edge (only those
            # carry the NIC factor) is precomputed per node in the layout's
            # _NodeNic cache, so a repeat event re-measures them in ONE
            # fused link_bw_many call and updates the touched DP rings via
            # the argmin fast path — no per-event index arithmetic.
            per = state.spec.gpus_per_node
            for node in ds.nics:
                ent = lay.node_nic(node, per)
                if ent is None:
                    continue
                bw = state.link_bw_many(ent.a, ent.b)
                if ent.tp_ids is not None and cache.tp_edge is not None:
                    cache.tp_edge.reshape(-1)[ent.tp_ids] = bw[:ent.off_dp]
                    tp_cells.update(ent.tp_cells)
                if ent.dp_ids is not None and cache.dp_edge is not None:
                    self._nic_dp_fast(
                        cache, ent, bw[ent.off_dp:ent.off_hop]
                    )
                if ent.hop_ids is not None and cache.hop_bw is not None:
                    cache.hop_bw.reshape(-1)[ent.hop_ids] = bw[ent.off_hop:]
                    hop_cols.update(ent.hop_cols)

        link_bw = state.link_bw
        for s, d2, e in tp_e:
            cache.tp_edge[s, d2, e] = link_bw(
                int(grid[s, d2, e]), int(grid[s, d2, (e + 1) % tp])
            )
            tp_cells.add((s, d2))
        for s, f, k2 in dp_e:
            cache.dp_edge[s, f, k2] = link_bw(
                int(grid[s, f, k2]), int(grid[s, (f + 1) % dp, k2])
            )
            dp_rings.add((s, k2))
        for hs, d2 in hop_e:
            cache.hop_bw[hs, d2] = link_bw(
                int(grid[hs, d2, 0]), int(grid[hs + 1, d2, 0])
            )
            hop_cols.add(d2)

        compute = state._compute
        host = state._host
        for s, d2 in cell_dirty:
            row = grid[s, d2]
            cache.cell_speed[s, d2] = (compute[row] * host[row]).min()
        for s, d2 in tp_cells:
            cache.tp_bw[s, d2] = cache.tp_edge[s, d2].min()
        stage_cols: set[int] = set()
        for s, d2 in cell_dirty | tp_cells:
            # Scalar replay of _stage_from through the factored constants.
            t = cache.c_flops / (cache.c_speed * cache.cell_speed[s, d2])
            if cache.tp_bw is not None:
                t += cache.c_tp / cache.tp_bw[s, d2]
            cache.stage[s, d2] = t
            stage_cols.add(d2)
        for d2 in stage_cols:
            cache.stage_max[d2] = max(cache.stage[:, d2].tolist())
        if len(dp_rings) > 2:
            rs = np.fromiter((s for s, _ in dp_rings), np.int64, len(dp_rings))
            rk = np.fromiter((k for _, k in dp_rings), np.int64, len(dp_rings))
            cache.dp_bw[rs, rk] = cache.dp_edge[rs, :, rk].min(axis=1)
            if cache.dp_arg is not None:
                cache.dp_arg[rs, rk] = -1
        else:
            for s, k2 in dp_rings:
                cache.dp_bw[s, k2] = cache.dp_edge[s, :, k2].min()
                if cache.dp_arg is not None:
                    cache.dp_arg[s, k2] = -1
        for d2 in hop_cols:
            # Sequential accumulation: the full pass's axis-0 sum reduces
            # row by row (never pairwise along the outer axis), and a 1-D
            # .sum() would switch to pairwise at >= 9 hops and drift a ulp.
            acc = 0.0
            for bw in cache.hop_bw[:, d2].tolist():
                acc += cache.pp_vol / bw
            cache.hop2[d2] = 2.0 * acc

    def _nic_dp_fast(self, cache: _Cells, ent, new: np.ndarray) -> None:
        """Scatter a node's re-measured DP-ring edges and refresh the
        touched rings' bottlenecks through the per-ring argmin cache.

        Correctness of the O(touched) rules (untouched edges are unchanged,
        so every untouched edge >= the ring's cached minimum ``cur``):

        * candidate ``cand`` = min over the touched edges' *new* values.
          If ``cand <= cur`` the ring minimum is exactly ``cand`` (any
          untouched edge >= cur >= cand) — assign value and argmin in O(1).
        * Else (every touched edge rose above ``cur``): if the cached
          bottleneck edge is *untouched*, its value still is ``cur`` and
          nothing beats it — the ring minimum is unchanged, no work.
        * Only when the bottleneck itself rose (a restore event) does the
          ring pay a full re-min + argmin. A stored argmin may be any
          position attaining the minimum (ties); the rule above stays valid
          for every such choice.

        The assigned floats are the same doubles a full ``.min(axis=1)``
        would produce, so bit-exactness against the reference oracles is
        preserved.
        """
        cache.dp_edge.reshape(-1)[ent.dp_ids] = new
        rs, rk = ent.ring_s, ent.ring_k
        if cache.dp_arg is None:
            cache.dp_arg = np.full(cache.dp_bw.shape, -1, dtype=np.int64)
        if not ent.uniform:
            # Irregular edges-per-ring grouping (nonstandard topology):
            # fall back to full re-min over the touched rings.
            sub = cache.dp_edge[rs, :, rk]
            cache.dp_bw[rs, rk] = sub.min(axis=1)
            cache.dp_arg[rs, rk] = sub.argmin(axis=1)
            return
        m = new[ent.dp_order].reshape(rs.size, ent.dp_width)
        j = m.argmin(axis=1)
        cand = m[ent.dp_rows, j]
        cur = cache.dp_bw[rs, rk]
        take = cand <= cur
        if take.all():
            # Degrade event: every touched ring's candidate wins — O(1)
            # per ring, no gathers (the common fast-path in churn).
            cache.dp_bw[rs, rk] = cand
            cache.dp_arg[rs, rk] = ent.dp_dpos2[ent.dp_rows, j]
            return
        curarg = cache.dp_arg[rs, rk]
        redo = ~take & (
            (curarg < 0) | (ent.dp_dpos2 == curarg[:, None]).any(axis=1)
        )
        if not take.any():
            # Restore event: only rings whose cached bottleneck edge rose
            # (or whose argmin is unknown) pay a full re-min + argmin.
            if redo.all():
                sub = cache.dp_edge[rs, :, rk]
                cache.dp_bw[rs, rk] = sub.min(axis=1)
                cache.dp_arg[rs, rk] = sub.argmin(axis=1)
            elif redo.any():
                sub = cache.dp_edge[rs[redo], :, rk[redo]]
                cache.dp_bw[rs[redo], rk[redo]] = sub.min(axis=1)
                cache.dp_arg[rs[redo], rk[redo]] = sub.argmin(axis=1)
            return
        cand_d = ent.dp_dpos2[ent.dp_rows, j]
        cache.dp_bw[rs[take], rk[take]] = cand[take]
        cache.dp_arg[rs[take], rk[take]] = cand_d[take]
        if redo.any():
            sub = cache.dp_edge[rs[redo], :, rk[redo]]
            cache.dp_bw[rs[redo], rk[redo]] = sub.min(axis=1)
            cache.dp_arg[rs[redo], rk[redo]] = sub.argmin(axis=1)

    def _cells_update_positions(
        self, cache: _Cells, lay: _Layout, pos: np.ndarray
    ) -> None:
        """Re-reduce only what the logical positions ``pos`` touch: their
        incident ring edges, then the containing cells' speed minima, stage
        times, ring minima and activation hops.

        Each update applies the exact operation chain of the full pass to
        the touched slices (same gathers, same reduction order over the
        same cached values), so the arrays stay bit-identical to a
        from-scratch rebuild.
        """
        state = self.state
        pp, dp, tp = self.job.pp, self.job.dp, self.job.tp
        grid = lay.grid
        if pos.size <= 3:
            # The batched path below costs ~30 small array ops regardless of
            # size; for the 1-2 positions a device or link event dirties,
            # per-position scalar updates are cheaper (re-reducing a shared
            # cell twice just re-stores the same bits). Node-scoped dirt
            # (CPU/NIC: a whole node's devices) stays on the batched path.
            for p in pos:
                self._cell_update_one(cache, lay, int(p))
            return
        s = pos // (dp * tp)
        rem = pos % (dp * tp)
        dd = rem // tp
        kk = rem % tp
        cells = np.unique(s * dp + dd)
        cs, cd = cells // dp, cells % dp
        rows = grid[cs, cd]  # (m, tp)
        cache.cell_speed[cs, cd] = (
            state._compute[rows] * state._host[rows]
        ).min(axis=1)
        # One fused link_bw_many sweep over every dirty ring/hop edge, then
        # scatter the results back per edge class. A position's incident
        # edges: k-1 -> k and k -> k+1 in its TP cell, d-1 -> d and d -> d+1
        # in its DP ring (indices mod size; duplicates re-store equal bits).
        seg_a: list[np.ndarray] = []
        seg_b: list[np.ndarray] = []
        tp_idx = dp_idx = hop_idx = None
        if cache.tp_edge is not None:
            es = np.concatenate([s, s])
            ed = np.concatenate([dd, dd])
            ek = np.concatenate([(kk - 1) % tp, kk])
            tp_idx = (es, ed, ek)
            seg_a.append(grid[es, ed, ek])
            seg_b.append(grid[es, ed, (ek + 1) % tp])
        if cache.dp_edge is not None:
            es = np.concatenate([s, s])
            ek = np.concatenate([kk, kk])
            ed = np.concatenate([(dd - 1) % dp, dd])
            dp_idx = (es, ed, ek)
            seg_a.append(grid[es, ed, ek])
            seg_b.append(grid[es, (ed + 1) % dp, ek])
        if cache.hop_bw is not None:
            hs, hd = s[kk == 0], dd[kk == 0]
            up, down = hs > 0, hs < pp - 1
            hops = np.unique(np.concatenate(
                [(hs[up] - 1) * dp + hd[up], hs[down] * dp + hd[down]]
            ))
            if hops.size:
                hop_idx = (hops // dp, hops % dp)
                seg_a.append(grid[hop_idx[0], hop_idx[1], 0])
                seg_b.append(grid[hop_idx[0] + 1, hop_idx[1], 0])
        if seg_a:
            bw = state.link_bw_many(
                np.concatenate(seg_a), np.concatenate(seg_b)
            )
            off = 0
            if tp_idx is not None:
                m = tp_idx[0].size
                cache.tp_edge[tp_idx] = bw[off:off + m]
                off += m
                cache.tp_bw[cs, cd] = cache.tp_edge[cs, cd].min(axis=1)
            if dp_idx is not None:
                m = dp_idx[0].size
                cache.dp_edge[dp_idx] = bw[off:off + m]
                off += m
                rings = np.unique(s * tp + kk)
                rs, rk = rings // tp, rings % tp
                cache.dp_bw[rs, rk] = cache.dp_edge[rs, :, rk].min(axis=1)
                if cache.dp_arg is not None:
                    cache.dp_arg[rs, rk] = -1
            if hop_idx is not None:
                cache.hop_bw[hop_idx] = bw[off:]
        cache.stage[cs, cd] = self._stage_from(
            cache.cell_speed[cs, cd],
            None if cache.tp_bw is None else cache.tp_bw[cs, cd],
        )
        cache.stage_max[cd] = cache.stage[:, cd].max(axis=0)
        if cache.hop_bw is not None:
            cache.hop2[cd] = 2.0 * (
                cache.pp_vol / cache.hop_bw[:, cd]
            ).sum(axis=0)

    def _cell_update_one(self, cache: _Cells, lay: _Layout, p: int) -> None:
        """Scalar fast path of :meth:`_cells_update_positions` for the
        single-position dirt a typical fail-slow event produces — plain
        index arithmetic instead of array batching, same operation chains
        (``link_bw`` and ``link_bw_many`` are kept in bit-identical
        lockstep, see :mod:`repro_torch.cluster.spec`)."""
        state = self.state
        pp, dp, tp = self.job.pp, self.job.dp, self.job.tp
        grid = lay.grid
        s, rem = divmod(p, dp * tp)
        d2, k2 = divmod(rem, tp)
        row = grid[s, d2]  # (tp,) view
        cache.cell_speed[s, d2] = (
            state._compute[row] * state._host[row]
        ).min()
        if cache.tp_edge is not None:
            e0 = (k2 - 1) % tp
            for e in (e0, k2) if e0 != k2 else (k2,):
                cache.tp_edge[s, d2, e] = state.link_bw(
                    int(row[e]), int(row[(e + 1) % tp])
                )
            cache.tp_bw[s, d2] = cache.tp_edge[s, d2].min()
        cache.stage[s, d2] = self._stage_from(
            cache.cell_speed[s, d2],
            None if cache.tp_bw is None else cache.tp_bw[s, d2],
        )
        if cache.dp_edge is not None:
            f0 = (d2 - 1) % dp
            for f in (f0, d2) if f0 != d2 else (d2,):
                cache.dp_edge[s, f, k2] = state.link_bw(
                    int(grid[s, f, k2]), int(grid[s, (f + 1) % dp, k2])
                )
            cache.dp_bw[s, k2] = cache.dp_edge[s, :, k2].min()
            if cache.dp_arg is not None:
                cache.dp_arg[s, k2] = -1
        if cache.hop_bw is not None and k2 == 0:
            for hs in (s - 1, s):
                if 0 <= hs < pp - 1:
                    cache.hop_bw[hs, d2] = state.link_bw(
                        int(grid[hs, d2, 0]), int(grid[hs + 1, d2, 0])
                    )
        cache.stage_max[d2] = cache.stage[:, d2].max()
        if cache.hop_bw is not None:
            # Sequential like the full pass's axis-0 sum (see _apply_dirty).
            acc = 0.0
            for bw in cache.hop_bw[:, d2].tolist():
                acc += cache.pp_vol / bw
            cache.hop2[d2] = 2.0 * acc

    def _cells_if_current(self) -> _Cells | None:
        """The cell cache, brought up to date with the state's mutation log
        — or None when it must be rebuilt (placement/state/job/cluster
        reassigned, incremental mode off, or the reader's cursor fell off
        the retained log). Single source of the freshness rule for both
        :meth:`_cells` and :meth:`remap_groups`."""
        d = self.__dict__
        cache = d.get("_cells_cache")
        if (
            cache is None
            or not self.incremental
            or d.get("_cells_place_ver") != d["_place_ver"]
            or d.get("_cells_state_uid") != self.state.uid
        ):
            return None
        ds = self.state.dirty_since(d["_cells_cursor"])
        d["_cells_cursor"] = self.state.cursor()
        if ds.full:
            return None
        if ds:
            self._apply_dirty(cache, self._layout(), ds)
        return cache

    def _cells(self) -> _Cells:
        """The cached per-cell reductions, refreshed event-scoped.

        Consumes the state's mutation log from this simulator's cursor:
        an empty dirty set returns the cache untouched, a typed dirty set
        re-reduces only the affected cells, and a full/overflowed one (or
        any placement/job/cluster/state reassignment) rebuilds everything —
        the pre-refactor behavior.
        """
        cache = self._cells_if_current()
        if cache is not None:
            return cache
        d = self.__dict__
        lay = self._layout()
        cache = self._cells_rebuild(lay)
        d["_cells_cache"] = cache
        d["_cells_place_ver"] = d["_place_ver"]
        d["_cells_state_uid"] = self.state.uid
        d["_cells_cursor"] = self.state.cursor()
        return cache

    def _stage_times(self) -> np.ndarray:
        """Per-(stage, dp_rank) time of one micro-batch, shape (pp, dp)."""
        return self._cells().stage

    def _dp_ring_times(self, volume: float, c: _Cells | None = None) -> np.ndarray:
        """All-reduce time of every (stage, tp_rank) DP ring, shape (pp, tp)."""
        bw = (c or self._cells()).dp_bw
        return 2.0 * (self.job.dp - 1) / self.job.dp * volume / bw

    def _alloc_off(self) -> np.ndarray:
        """``allocation + pp - 1`` as an int64 array, memoized until the
        allocation list is reassigned (integer arithmetic, order-exact)."""
        d = self.__dict__
        if d.get("_alloc_arr") is None:
            d["_alloc_arr"] = (
                np.asarray(self.allocation, dtype=np.int64) + self.job.pp - 1
            )
        return d["_alloc_arr"]

    def _reduction_backend(self):
        """The resolved :data:`REDUCTION_BACKENDS` instance, or None for
        the inline vectorized fast path (the hot-path default — no
        per-call indirection). Resolved lazily, re-resolved whenever the
        ``reduction`` field is reassigned."""
        d = self.__dict__
        obj = d.get("_red_obj", False)
        if obj is False:
            obj = resolve_reduction_backend(self.reduction, device=self.device)
            d["_red_obj"] = obj
        return obj

    def iteration_time(self) -> float:
        key = (self.__dict__["_cfg_ver"], self.state.version)
        d = self.__dict__
        if d.get("_it_key") == key:
            return d["_it_val"]
        rb = self._reduction_backend()
        t = (
            self._vec_iteration_time() if rb is None
            else float(rb.iteration_time(self))
        )
        d["_it_key"] = key
        d["_it_val"] = t
        return t

    def _vec_iteration_time(self) -> float:
        """The vectorized (numpy) reduction tree over the cell cache."""
        c = self._cells()
        pipe = self._alloc_off() * c.stage_max
        if c.hop_bw is not None:
            pipe += c.hop2
        t = float(pipe.max())
        if self.job.dp > 1:
            # max over C / bw == C / bw.min(): the winning element is the
            # same division of the same two doubles either way.
            t += float(c.c_dp / c.dp_bw.min())
        return t

    def per_microbatch_times(self) -> list[float]:
        """Per-DP-group per-micro-batch processing time (S2 solver input)."""
        rb = self._reduction_backend()
        if rb is not None:
            return rb.per_microbatch_times(self)
        return [float(v) for v in self._cells().stage_max]

    # -------------------------------------- per-collective decomposition
    def collective_breakdown(self) -> CollectiveBreakdown:
        """The current iteration's critical-path time split into compute /
        TP-allreduce / PP-p2p / DP-allreduce, with the bottleneck
        collective, profiling group and ring edge named (local ranks —
        the same ids the detector's component validation uses). Reads the
        cached per-cell reductions, so after an ``iteration_time()`` it
        costs O(cells); the control plane attaches one to every onset
        Diagnosis. See docs/observability.md for the contract.
        """
        return decompose(self)

    def timing_decomposition(self) -> dict[str, list]:
        """Every cell's time split as nested lists — the per-cell
        companion of :meth:`collective_breakdown` (TP/DP entries match
        :meth:`profile_groups` bit for bit)."""
        return timing_decomposition(self)

    def healthy_iteration_time(self) -> float:
        """Iteration time with all components healthy and even allocation.

        Depends only on the (immutable) job and cluster specs, so it is
        computed once per simulator.
        """
        d = self.__dict__
        if d.get("_healthy_cache") is None:
            saved_state, saved_alloc = self.state, self.allocation
            saved_place = self.placement
            self.state = ClusterState(self.cluster)
            base, extra = divmod(self.job.micro_batches, self.job.dp)
            self.allocation = [
                base + (1 if i < extra else 0) for i in range(self.job.dp)
            ]
            self.placement = list(range(self.job.n_devices))
            t = self.iteration_time()
            self.state, self.allocation, self.placement = (
                saved_state, saved_alloc, saved_place,
            )
            d["_healthy_cache"] = t
        return d["_healthy_cache"]

    # ----------------------------------------- reference implementations
    # The seed's nested-loop model, kept verbatim as the equivalence oracle
    # for the vectorized fast path (tests pin both to 1e-9; in practice the
    # operation chains are identical and results match bit for bit).
    def _cell_speed(self, stage: int, dp_rank: int) -> float:
        """TP-synchronized cell runs at its slowest member's speed."""
        return min(self.state.effective_speed(d) for d in self._cell_devices(stage, dp_rank))

    def _ring_time(self, devices: list[int], volume: float) -> float:
        """Ring all-reduce time: 2(n-1)/n x volume over the slowest edge."""
        n = len(devices)
        if n <= 1 or volume <= 0:
            return 0.0
        bw = min(
            self.state.link_bw(devices[i], devices[(i + 1) % n]) for i in range(n)
        )
        return 2.0 * (n - 1) / n * volume / bw

    def _stage_time_per_microbatch(self, stage: int, dp_rank: int) -> float:
        m = self.job.model
        compute = m.flops_per_microbatch() / self.job.pp / (
            self.job.tp * self.cluster.gpu_flops * self._cell_speed(stage, dp_rank)
        )
        tp_vol = m.comm_tp_bytes(self.job.tp, self.job.pp, 1)
        tp_time = self._ring_time(self._cell_devices(stage, dp_rank), tp_vol)
        return compute + tp_time

    def _pipeline_time(self, dp_rank: int) -> float:
        """1F1B: (m + P - 1) x slowest stage + activation hops."""
        m_d = self.allocation[dp_rank]
        stage_t = max(
            self._stage_time_per_microbatch(s, dp_rank) for s in range(self.job.pp)
        )
        pp_vol = self.job.model.comm_pp_bytes(1)
        hop = 0.0
        for s in range(self.job.pp - 1):
            a = self.device_at(s, dp_rank, 0)
            b = self.device_at(s + 1, dp_rank, 0)
            hop += pp_vol / self.state.link_bw(a, b)
        return (m_d + self.job.pp - 1) * stage_t + 2.0 * hop

    def _dp_allreduce_time(self) -> float:
        if self.job.dp <= 1:
            return 0.0
        vol = self.job.model.comm_dp_bytes(self.job.tp, self.job.pp)
        worst = 0.0
        for s in range(self.job.pp):
            for k in range(self.job.tp):
                ring = [self.device_at(s, d, k) for d in range(self.job.dp)]
                worst = max(worst, self._ring_time(ring, vol))
        return worst

    def iteration_time_reference(self) -> float:
        """Original loop implementation (equivalence oracle; no memo)."""
        pipe = max(self._pipeline_time(d) for d in range(self.job.dp))
        return pipe + self._dp_allreduce_time()

    def per_microbatch_times_reference(self) -> list[float]:
        return [
            max(
                self._stage_time_per_microbatch(s, d) for s in range(self.job.pp)
            )
            for d in range(self.job.dp)
        ]

    def profile_groups_reference(self) -> dict[str, float]:
        out: dict[str, float] = {}
        m = self.job.model
        tp_vol = m.comm_tp_bytes(self.job.tp, self.job.pp, 1)
        dp_vol = m.comm_dp_bytes(self.job.tp, self.job.pp)
        for s in range(self.job.pp):
            for d in range(self.job.dp):
                if self.job.tp > 1:
                    cell = self._cell_devices(s, d)
                    out[f"tp:s{s}d{d}"] = self._ring_time(cell, tp_vol)
            for k in range(self.job.tp):
                if self.job.dp > 1:
                    ring = [self.device_at(s, d, k) for d in range(self.job.dp)]
                    out[f"dp:s{s}t{k}"] = self._ring_time(ring, dp_vol)
        return out

    # -------------------------------------------------- mitigation hooks
    def set_allocation(self, counts: list[int]) -> None:
        if len(counts) != self.job.dp or sum(counts) != self.job.micro_batches:
            raise ValueError("bad allocation")
        self.allocation = list(counts)

    def apply_placement(self, perm: list[int]) -> None:
        """Compose a logical->physical permutation onto current placement."""
        if sorted(perm) != list(range(self.job.n_devices)):
            raise ValueError("not a permutation")
        self.placement = [self.placement[p] for p in perm]

    def remap_groups(self, placement: list[int]) -> None:
        """Re-shape communication groups to an explicit device placement.

        ``placement`` lists the physical device for every logical position
        (HybridTopology stage-major order) and must permute the job's
        *current* device set — this is the placement-aware mitigation hook
        (:mod:`repro_torch.core.placement`): swapping ranks across DP groups
        concentrates a slow host's members into few groups so S2/S3 have
        skew to exploit.

        Unlike reassigning ``placement`` directly, the cached
        :class:`_Layout` is refreshed *incrementally* (index tensors
        rebuilt in place, group-key strings reused) instead of being built
        from scratch on the next evaluation — and the per-cell reduction
        cache stays live: only cells whose membership actually changed (plus
        any pending state dirt) are re-reduced, so a measure-before-commit
        candidate sweep (S2P/S3P) pays per remapped cell, not per cluster.
        """
        new_arr = np.asarray(placement, dtype=np.int64)
        old_arr = np.asarray(self.placement, dtype=np.int64)
        if new_arr.shape != old_arr.shape:
            raise ValueError("remap must permute the job's current devices")
        changed = np.flatnonzero(new_arr != old_arr)
        # Permutation check on the changed subset only (unchanged positions
        # cancel out of the multiset comparison) — O(moved log moved), not
        # O(devices log devices) per candidate evaluation.
        if not np.array_equal(
            np.sort(new_arr[changed]), np.sort(old_arr[changed])
        ):
            raise ValueError("remap must permute the job's current devices")
        new = new_arr.tolist()
        d = self.__dict__
        lay = d.get("_layout_cache")
        fresh = lay is not None and d.get("_layout_ver") == d.get("_place_ver")
        # Sync any unapplied state dirt against the *old* grid first (the
        # cache must equal a rebuild for the old placement before the
        # membership delta is applied on top).
        cache = self._cells_if_current()
        self.placement = new  # bumps placement/config versions
        if fresh:
            lay.update(new, self.job)
            d["_layout_ver"] = d["_place_ver"]
        if cache is not None:
            # Re-reduce only the positions whose device changed.
            if changed.size:
                self._cells_update_positions(cache, self._layout(), changed)
            d["_cells_place_ver"] = d["_place_ver"]

    def restart(self) -> None:
        """S4: checkpoint-and-restart onto healthy devices (modeled as a
        placement reset + the caller charging the restart overhead)."""
        self.placement = list(range(self.job.n_devices))
        base, extra = divmod(self.job.micro_batches, self.job.dp)
        self.allocation = [base + (1 if i < extra else 0) for i in range(self.job.dp)]

    # -------------------------------------------- hang / stall semantics
    #: a job is *stalled* (hung, not merely degraded) when its iteration
    #: runs this many times slower than healthy — far past any composition
    #: of severity-tier throttles, but far below the ~10⁶× a HANG_EPS
    #: injection produces, so throttles never trip it and hangs always do
    stall_factor = 500.0

    def stalled(self) -> bool:
        """True when the job makes effectively no progress (a hang).

        A stalled job emits no iteration samples: the monitor's current
        iteration never completes, which is exactly the stream-goes-silent
        shape the control plane's watchdog exists to catch.
        """
        return (
            self.iteration_time()
            >= self.stall_factor * self.healthy_iteration_time()
        )

    # ------------------------------------------------ snapshot / restore
    def snapshot(self) -> dict:
        """Capture placement, micro-batch allocation, and hardware state.

        The fault-tolerant executor snapshots before every mitigation
        attempt and calls :meth:`restore` when the attempt fails mid-flight,
        guaranteeing the simulator is bit-identical to its pre-action state.
        """
        st = self.state
        return {
            "placement": list(self.placement),
            "allocation": list(self.allocation),
            "compute": st._compute.copy(),
            "host": st._host.copy(),
            "link_mult": dict(st.link_mult),
            "nic_mult": dict(st.nic_mult),
        }

    def restore(self, snap: dict) -> None:
        """Roll back to a :meth:`snapshot`, through the logged surfaces.

        Every write goes through the same mutation-logged setters the
        injector uses (and diffs against the current value first), so the
        dirty-set/memoization contracts hold and an already-identical
        component contributes no spurious dirt.
        """
        if list(self.placement) != snap["placement"]:
            self.placement = list(snap["placement"])
        if list(self.allocation) != snap["allocation"]:
            self.allocation = list(snap["allocation"])
        st = self.state
        comp, host = snap["compute"], snap["host"]
        for i in np.flatnonzero(st._compute != comp):
            st.devices[int(i)].compute_speed = float(comp[i])
        for i in np.flatnonzero(st._host != host):
            st.devices[int(i)].host_speed = float(host[i])
        for vdict, saved in (
            (st.link_mult, snap["link_mult"]),
            (st.nic_mult, snap["nic_mult"]),
        ):
            for k in list(vdict):
                if k not in saved:
                    del vdict[k]
            for k, v in saved.items():
                vdict[k] = v  # no-ops (and stays clean) when already equal

    # ---------------------------------------------- monitor event stream
    ITER_PATTERN = (CommOp.REDUCE_SCATTER, CommOp.ALL_GATHER, CommOp.ALL_REDUCE)

    def emit_events(self, t_start: float, iter_time: float, rank: int = 0) -> list[CommEvent]:
        """CommEvents one real iteration would leave in the Monitor log."""
        k = len(self.ITER_PATTERN)
        return [
            CommEvent(op=op, timestamp=t_start + iter_time * (i / k), rank=rank)
            for i, op in enumerate(self.ITER_PATTERN)
        ]

    # --------------------------------------- dirty-cursor adapter surface
    def state_cursor(self) -> tuple[int, int]:
        """Opaque cursor over the hardware mutation log: (state identity,
        log position — see :meth:`repro_torch.cluster.spec.ClusterState.cursor`).
        Control-plane readers store this and poll :meth:`dirty_since` to
        learn which hardware components moved — each registered job keeps
        its own cursor, so one job's faults cost co-registered jobs
        nothing. The identity token guards against ``sim.state`` being
        reassigned wholesale (probe swaps, restarts onto a fresh state):
        a cursor from the old state reads as everything-dirty, never as
        clean."""
        return (self.state.uid, self.state.cursor())

    def dirty_since(self, cursor: tuple[int, int]):
        """Typed :class:`~repro_torch.cluster.spec.DirtySet` of components mutated
        since ``cursor`` (device ranks, link pairs, NIC nodes — all in this
        job's local coordinates). Full-dirty when the cursor belongs to a
        previous state object."""
        uid, pos = cursor
        if uid != self.state.uid:
            return DirtySet(full=True)
        return self.state.dirty_since(pos)

    # ------------------------------------- ClusterInterface (FALCON R1)
    def profile_groups(self) -> dict[str, float]:
        """Per-communication-group transfer time (profiling phase)."""
        rb = self._reduction_backend()
        if rb is not None:
            return rb.profile_groups(self)
        return self._vec_profile_groups()

    def _vec_profile_groups(self) -> dict[str, float]:
        lay = self._layout()
        c = self._cells()
        out: dict[str, float] = {}
        m = self.job.model
        if c.tp_bw is not None:
            tp_vol = m.comm_tp_bytes(self.job.tp, self.job.pp, 1)
            times = 2.0 * (self.job.tp - 1) / self.job.tp * tp_vol / c.tp_bw
            out.update(zip(lay.tp_keys, times.reshape(-1).tolist(), strict=True))
        if c.dp_bw is not None:
            dp_vol = m.comm_dp_bytes(self.job.tp, self.job.pp)
            times = self._dp_ring_times(dp_vol)
            out.update(zip(lay.dp_keys, times.reshape(-1).tolist(), strict=True))
        return out

    def group_ranks(self, group: str) -> list[int]:
        kind, coords = group.split(":")
        if kind == "tp":
            s, d = coords[1:].split("d")
            return self._cell_devices(int(s), int(d))
        s, k = coords[1:].split("t")
        return [self.device_at(int(s), d, int(k)) for d in range(self.job.dp)]

    def benchmark_compute(self, ranks: list[int]) -> dict[int, float]:
        """GEMM validation: time inversely proportional to device speed.

        CPU contention does *not* show up here (paper case study 1: the GPU
        matmul test found no degradation) — only compute_speed matters.
        """
        return {
            r: self.cluster.gemm_ref_time / self.state.devices[r].compute_speed
            for r in ranks
        }

    def measure_link(self, pair: tuple[int, int]) -> float:
        a, b = pair
        return self.cluster.p2p_payload / self.state.link_bw(a, b)

    def measure_links(self, pairs: np.ndarray) -> np.ndarray:
        """Batched :meth:`measure_link` over an (k, 2) pair array.

        Rides on :meth:`ClusterState.link_bw_many`, so one call validates
        every ring pass of every suspicious group — the detector's
        vectorized validation sweep."""
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        return self.cluster.p2p_payload / self.state.link_bw_many(
            pairs[:, 0], pairs[:, 1]
        )

    def healthy_link_time(self, pair: tuple[int, int]) -> float:
        """Expected healthy time for this link class (fabric is known)."""
        a, b = pair
        return self.cluster.p2p_payload / self.cluster.base_link_bw(a, b)

    def healthy_link_times(self, pairs: np.ndarray) -> np.ndarray:
        """Batched :meth:`healthy_link_time` over an (k, 2) pair array."""
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        return self.cluster.p2p_payload / self.cluster.base_link_bw_many(
            pairs[:, 0], pairs[:, 1]
        )

    def healthy_compute_time(self) -> float:
        """Reference GEMM time on a healthy device."""
        return self.cluster.gemm_ref_time

    # -------------------------------------- node-scoped validation surface
    def node_of_rank(self, rank: int) -> int:
        """Node hosting a device rank (NIC/host clustering in validation)."""
        return self.cluster.node_of(rank)

    def benchmark_host(self, nodes: list[int]) -> dict[int, float]:
        """Host-side benchmark per node: CPU contention slows the whole
        node's host path, which the GPU GEMM sweep cannot see."""
        per = self.cluster.gpus_per_node
        out: dict[int, float] = {}
        for n in nodes:
            speed = min(
                self.state.devices[d].host_speed
                for d in range(n * per, (n + 1) * per)
            )
            out[n] = self.cluster.host_ref_time / speed
        return out

    def healthy_host_time(self) -> float:
        """Reference host benchmark time on a healthy node."""
        return self.cluster.host_ref_time

    def measure_nic(self, node: int) -> float:
        """P2P time through one node's NIC port (inter-node path)."""
        return self.cluster.p2p_payload / (
            self.cluster.inter_node_bw * self.state.nic_mult.get(node, 1.0)
        )

    def healthy_nic_time(self) -> float:
        """Expected healthy inter-node P2P time (NIC at full rate)."""
        return self.cluster.p2p_payload / self.cluster.inter_node_bw


# ---------------------------------------------------------------------------
# Reduction backends
# ---------------------------------------------------------------------------
@runtime_checkable
class ReductionBackend(Protocol):
    """How a :class:`TrainingSimulator` turns its measured per-cell arrays
    into iteration-level answers.

    Implementations own everything downstream of measurement — the ring
    minima, stage maxima, hop sums and critical-path reductions — and are
    interchangeable behind ``TrainingSimulator.reduction``. ``tolerance``
    is the documented relative error versus the ``reference`` loop oracle
    (0.0 = bit-exact); the equivalence suite enumerates
    :data:`REDUCTION_BACKENDS` and asserts each backend within its own
    tolerance. See docs/kernels.md for the contract and how to register a
    new backend.
    """

    name: str
    tolerance: float

    def iteration_time(self, sim: TrainingSimulator) -> float: ...

    def per_microbatch_times(self, sim: TrainingSimulator) -> list[float]: ...

    def profile_groups(self, sim: TrainingSimulator) -> dict[str, float]: ...


class ReferenceReduction:
    """The seed's nested-loop oracle as a backend (slow, bit-exact)."""

    name = "reference"
    tolerance = 0.0

    def iteration_time(self, sim: TrainingSimulator) -> float:
        return sim.iteration_time_reference()

    def per_microbatch_times(self, sim: TrainingSimulator) -> list[float]:
        return sim.per_microbatch_times_reference()

    def profile_groups(self, sim: TrainingSimulator) -> dict[str, float]:
        return sim.profile_groups_reference()


class VectorizedReduction:
    """The numpy fast path as an explicit backend object.

    ``sim.reduction = "vectorized"`` skips
    this object entirely and runs the same code inline — this class exists
    so the equivalence suite can drive every registry entry uniformly.
    """

    name = "vectorized"
    tolerance = 0.0

    def iteration_time(self, sim: TrainingSimulator) -> float:
        return sim._vec_iteration_time()

    def per_microbatch_times(self, sim: TrainingSimulator) -> list[float]:
        return [float(v) for v in sim._cells().stage_max]

    def profile_groups(self, sim: TrainingSimulator) -> dict[str, float]:
        return sim._vec_profile_groups()


class TorchReduction:
    """The reduction tree's plain PyTorch version
    (:func:`repro_torch.kernels.cell_reduce.cell_reduce_reference`) on
    ``device`` (None = the card), one call per evaluation, memoized on the
    simulator's config/state versions.

    Measurement (and its event-scoped incremental maintenance) stays on the
    numpy side; the cell arrays are copied to the device once per memo key
    (``copies`` / ``copy_bytes`` count that traffic). Topologies with tp,
    dp or pp equal to 1 take the reference's own numpy path. Runs in
    float64, where the result matches the loop oracle to rounding.
    """

    name = "torch"
    tolerance = 1e-12
    dtype = torch.float64

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self.copies = 0
        self.copy_bytes = 0

    _reduce = staticmethod(cell_reduce_reference)

    def _outs(self, sim: TrainingSimulator):
        d = sim.__dict__
        key = (d["_cfg_ver"], sim.state.version)
        if d.get("_red_key") == key:
            return d["_red_val"]
        c = sim._cells()
        if c.tp_edge is None or c.dp_edge is None or c.hop_bw is None:
            out = None
        else:
            host = (c.cell_speed, c.tp_edge, c.dp_edge, c.hop_bw,
                    sim._alloc_off())
            self.copies += 1
            self.copy_bytes += sum(a.nbytes for a in host)
            dev = [
                torch.as_tensor(a).to(device=self.device, dtype=self.dtype)
                for a in host
            ]
            t, stage_max, tp_bw, dp_bw = self._reduce(
                *dev, c.c_flops, c.c_speed, c.c_tp, c.pp_vol, c.c_dp,
            )
            # One device-to-host copy for all four results.
            flat = torch.cat([
                t.reshape(-1), stage_max.reshape(-1), tp_bw.reshape(-1),
                dp_bw.reshape(-1),
            ]).to(torch.float64).cpu().numpy()
            job = sim.job
            n_tp = job.pp * job.dp
            out = (
                float(flat[0]),
                flat[1:1 + job.dp].tolist(),
                flat[1 + job.dp:1 + job.dp + n_tp].reshape(job.pp, job.dp),
                flat[1 + job.dp + n_tp:].reshape(job.pp, job.tp),
            )
        d["_red_key"] = key
        d["_red_val"] = out
        return out

    def iteration_time(self, sim: TrainingSimulator) -> float:
        out = self._outs(sim)
        return sim._vec_iteration_time() if out is None else out[0]

    def per_microbatch_times(self, sim: TrainingSimulator) -> list[float]:
        out = self._outs(sim)
        if out is None:
            return [float(v) for v in sim._cells().stage_max]
        return list(out[1])

    def profile_groups(self, sim: TrainingSimulator) -> dict[str, float]:
        out = self._outs(sim)
        if out is None:
            return sim._vec_profile_groups()
        _, _, tp_bw, dp_bw = out
        lay = sim._layout()
        m = sim.job.model
        job = sim.job
        res: dict[str, float] = {}
        tp_vol = m.comm_tp_bytes(job.tp, job.pp, 1)
        times = 2.0 * (job.tp - 1) / job.tp * tp_vol / tp_bw
        res.update(zip(lay.tp_keys, times.reshape(-1).tolist(), strict=True))
        dp_vol = m.comm_dp_bytes(job.tp, job.pp)
        times = 2.0 * (job.dp - 1) / job.dp * dp_vol / dp_bw
        res.update(zip(lay.dp_keys, times.reshape(-1).tolist(), strict=True))
        return res


class CudaReduction(TorchReduction):
    """Fused-kernel backend: one launch of the hand-written CUDA kernel
    (:func:`repro_torch.kernels.cell_reduce.cell_reduce`) per evaluation —
    the twin of the reference's ``PallasReduction``. Runs in float32, the
    accelerator's width; ``tolerance`` reflects float32 arithmetic against
    the float64 oracle."""

    name = "cuda"
    tolerance = 1e-4
    dtype = torch.float32

    _reduce = staticmethod(cell_reduce)


#: registry the equivalence tests enumerate; "numpy" mirrors the screening
#: registry's alias for the default non-kernel path. ``torch`` is the
#: kernel's plain PyTorch version, ``cuda`` the kernel itself.
REDUCTION_BACKENDS: dict[str, type] = {
    "reference": ReferenceReduction,
    "vectorized": VectorizedReduction,
    "numpy": VectorizedReduction,
    "torch": TorchReduction,
    "cuda": CudaReduction,
}


def _auto_reduction(device=None):
    """``auto``: the kernel on the card (raising when there is none), the
    plain version when ``device`` names the CPU."""
    dev = resolve_device(device)
    return CudaReduction(dev) if dev.type == "cuda" else TorchReduction(dev)


def select_reduction_backend(name: str | None = None, device=None):
    """Instantiate a reduction backend by registry name; None/"auto" picks
    ``cuda`` on the card and raises without one (``torch`` when ``device``
    names the CPU). ``device`` binds the ``torch``/``cuda`` entries."""
    if name in (None, "auto"):
        return _auto_reduction(device)
    try:
        cls = REDUCTION_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown reduction backend {name!r}; "
            f"registered: {sorted(REDUCTION_BACKENDS)}"
        ) from None
    if issubclass(cls, TorchReduction):
        return cls(device)
    return cls()


def resolve_reduction_backend(spec, device=None):
    """``TrainingSimulator.reduction`` -> backend instance, or None for the
    inline vectorized fast path ("vectorized", "numpy"). Accepts a registry
    name or a ready ReductionBackend instance; "auto" is the CUDA kernel on
    the card and raises without one (see :func:`select_reduction_backend`)."""
    if spec in (None, "auto"):
        return _auto_reduction(device)
    if isinstance(spec, str):
        if spec in ("vectorized", "numpy"):
            return None
        return select_reduction_backend(spec, device)
    if hasattr(spec, "iteration_time"):
        return spec
    raise TypeError(
        f"reduction must be a registry name or ReductionBackend, got {spec!r}"
    )
