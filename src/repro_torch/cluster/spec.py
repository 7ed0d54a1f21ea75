"""Hardware and job specifications for the cluster performance model.

Default numbers model the paper's testbed-class hardware for the simulator
(H800-like compute, NVSwitch intra-node, 400 Gbps RoCE/IB inter-node) and
TPU v5e for the roofline analysis of the JAX runtime (the dry-run target).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

# --- TPU v5e constants (roofline target; per chip) -----------------------
TPU_PEAK_FLOPS_BF16 = 197e12  # FLOP/s
TPU_HBM_BW = 819e9  # bytes/s
TPU_ICI_BW = 50e9  # bytes/s per link

# --- GPU-cluster constants (simulator; per device) ------------------------
H800_TFLOPS = 989e12 / 2  # dense bf16 w/o sparsity
NVSWITCH_BW = 400e9  # bytes/s intra-node effective
PIX_BW = 64e9  # PCIe switch
RDMA_BW = 50e9  # 400 Gbps RoCE/IB per NIC in bytes/s


@dataclass(frozen=True)
class ModelSpec:
    """Transformer shape, following the paper's Appendix 9.2 notation."""

    layers: int
    hidden: int
    seq_len: int
    vocab: int
    micro_batch: int = 1  # b: sequences per micro-batch

    @property
    def params(self) -> float:
        """N ~= 12 L h^2 (Eq. 6)."""
        return 12.0 * self.layers * self.hidden**2 + self.vocab * self.hidden

    def flops_per_microbatch(self) -> float:
        """Fwd+bwd FLOPs for one micro-batch: ~6 N b s."""
        return 6.0 * self.params * self.micro_batch * self.seq_len

    # Communication volumes per iteration (Appendix 9.2), in bytes (bf16).
    def comm_tp_bytes(self, t: int, p: int, m: int) -> float:
        if t <= 1:
            return 0.0
        return 2.0 * 8 * self.micro_batch * m * self.seq_len * self.hidden * (
            self.layers * (t - 1) / (p * t)
        )

    def comm_dp_bytes(self, t: int, p: int) -> float:
        return 2.0 * self.params / (p * t)  # k = 1 gradient pass, bf16

    def comm_pp_bytes(self, m: int) -> float:
        return 2.0 * m * self.micro_batch * self.seq_len * self.hidden


@dataclass
class ClusterSpec:
    """A homogeneous GPU cluster: nodes x GPUs, two-tier network."""

    n_nodes: int
    gpus_per_node: int = 8
    gpu_flops: float = H800_TFLOPS
    intra_node_bw: float = NVSWITCH_BW
    inter_node_bw: float = RDMA_BW
    #: benchmark GEMM reference time on a healthy GPU (s)
    gemm_ref_time: float = 0.05
    #: P2P validation payload (bytes)
    p2p_payload: float = 256e6
    #: host-side (CPU/dataloader) benchmark reference time on a healthy node
    #: (s) — the validation probe that exposes CPU contention, which GPU
    #: GEMMs cannot see (paper case study 1)
    host_ref_time: float = 0.5

    @property
    def n_devices(self) -> int:
        return self.n_nodes * self.gpus_per_node

    def node_of(self, device: int) -> int:
        return device // self.gpus_per_node

    def base_link_bw(self, a: int, b: int) -> float:
        """Healthy bandwidth of the physical path between devices a and b."""
        if a == b:
            return float("inf")
        if self.node_of(a) == self.node_of(b):
            return self.intra_node_bw
        return self.inter_node_bw

    def base_link_bw_many(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`base_link_bw` (keep the two in lockstep: the
        detector's batched and scalar healthy-reference paths must agree)."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        bw = np.where(
            a // self.gpus_per_node == b // self.gpus_per_node,
            self.intra_node_bw,
            self.inter_node_bw,
        )
        return np.where(a == b, np.inf, bw)


#: retained mutation-log entries; readers whose cursor falls off the tail
#: get a conservative full-dirty set (they rebuild, exactly as before the
#: log existed), so the cap bounds memory without a correctness cliff
_LOG_CAP = 8192

#: unique ClusterState identity tokens — ``id()`` can be reused after GC,
#: which would let a reader mistake a fresh state for the one its cursor
#: (and cached reductions) were built against
_STATE_UIDS = itertools.count()


@dataclass(frozen=True)
class DirtySet:
    """Typed components mutated since a reader's cursor.

    ``full`` means the reader's cursor predates the retained log (or a
    legacy whole-state bump happened): everything must be treated dirty.
    The three component sets mirror the state's storage: device indices
    (compute *or* host speed changed), ``(min, max)`` link keys, NIC nodes.
    """

    full: bool = False
    devices: frozenset[int] = frozenset()
    links: frozenset[tuple[int, int]] = frozenset()
    nics: frozenset[int] = frozenset()

    def __bool__(self) -> bool:
        return self.full or bool(self.devices or self.links or self.nics)


_EMPTY_DIRTY = DirtySet()
_FULL_DIRTY = DirtySet(full=True)


class DeviceState:
    """Dynamic per-device health (multipliers; 1.0 = healthy).

    A view into the owning :class:`ClusterState`'s speed arrays: writes land
    in the vectorized storage and append to the state's mutation log, so the
    simulator's memoized iteration time invalidates on *any* mutation path —
    including direct ``state.devices[i].compute_speed = ...`` assignments —
    and incremental readers learn exactly which device moved.
    """

    __slots__ = ("_state", "_idx")

    def __init__(self, state: "ClusterState", idx: int) -> None:
        self._state = state
        self._idx = idx

    @property
    def compute_speed(self) -> float:  # GPU degradation / thermal throttling
        return float(self._state._compute[self._idx])

    @compute_speed.setter
    def compute_speed(self, v: float) -> None:
        if self._state._compute[self._idx] != v:
            self._state._compute[self._idx] = v
            self._state._note_device(self._idx)

    @property
    def host_speed(self) -> float:  # CPU contention (affects whole node)
        return float(self._state._host[self._idx])

    @host_speed.setter
    def host_speed(self, v: float) -> None:
        if self._state._host[self._idx] != v:
            self._state._host[self._idx] = v
            self._state._note_device(self._idx)

    def __repr__(self) -> str:
        return (f"DeviceState(compute_speed={self.compute_speed}, "
                f"host_speed={self.host_speed})")


class _VersionedDict(dict):
    """Dict that logs key-scoped mutations into its owner's mutation log."""

    __slots__ = ("_owner", "_kind")

    def __init__(self, owner: "ClusterState", kind: str, *args) -> None:
        super().__init__(*args)
        self._owner = owner
        self._kind = kind

    def __setitem__(self, key, value) -> None:
        if key in self and dict.__getitem__(self, key) == value:
            return
        super().__setitem__(key, value)
        self._owner._note(self._kind, key)

    def __delitem__(self, key) -> None:
        super().__delitem__(key)
        self._owner._note(self._kind, key)

    def pop(self, key, *default):
        had = key in self
        out = super().pop(key, *default)
        if had:
            self._owner._note(self._kind, key)
        return out

    def clear(self) -> None:
        if self:
            keys = list(self)
            super().clear()
            for key in keys:
                self._owner._note(self._kind, key)

    def update(self, *args, **kw) -> None:
        keys = list(dict(*args, **kw))
        super().update(*args, **kw)
        for key in keys:
            self._owner._note(self._kind, key)

    def setdefault(self, key, default=None):
        if key in self:
            return dict.__getitem__(self, key)
        super().__setitem__(key, default)
        self._owner._note(self._kind, key)
        return default

    def __ior__(self, other):
        self.update(other)
        return self

    def popitem(self):
        out = super().popitem()
        self._owner._note(self._kind, out[0])
        return out


@dataclass
class ClusterState:
    """Mutable health state of every device and link.

    Speeds are stored as dense arrays for the simulator's vectorized fast
    path. Every mutation (through device views, the versioned multiplier
    dicts, or ``reset``) appends a *typed* entry to a bounded mutation log;
    readers hold a cursor (:meth:`cursor`) and ask :meth:`dirty_since` for
    the :class:`DirtySet` of components that moved — the invalidation
    contract incremental iteration-time recomputation is built on (see
    docs/simulator.md). ``version`` — the log's write position — is kept as
    the derived compatibility property coarse-grained memo keys still use.
    """

    spec: ClusterSpec
    devices: list[DeviceState] = field(init=False)
    #: (min(a,b), max(a,b)) -> bandwidth multiplier
    link_mult: dict[tuple[int, int], float] = field(default_factory=dict)
    #: node -> NIC bandwidth multiplier (RoCE congestion hits the whole port,
    #: slowing every inter-node flow of that node, not one cable)
    nic_mult: dict[int, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        n = self.spec.n_devices
        self._uid = next(_STATE_UIDS)
        self._version = 0
        self._log: list[tuple[str, object]] = []
        self._log_base = 0  # version index of _log[0]
        self._compute = np.ones(n)
        self._host = np.ones(n)
        #: devices whose compute or host speed is currently != 1.0 — lets
        #: ``reset`` touch (and dirty) only what was actually degraded
        self._degraded: set[int] = set()
        #: memoized sorted-key lookup tables for ``link_bw_many`` (rebuilt
        #: lazily after any link/NIC mutation, so steady-state vectorized
        #: sweeps stop re-sorting the multiplier dicts every call)
        self._link_lookup: tuple[np.ndarray, np.ndarray] | None = None
        self._nic_lookup: np.ndarray | None = None
        self.devices = [DeviceState(self, i) for i in range(n)]
        self.link_mult = _VersionedDict(self, "link", self.link_mult)
        self.nic_mult = _VersionedDict(self, "nic", self.nic_mult)
        self._clean = not self.link_mult and not self.nic_mult

    @property
    def uid(self) -> int:
        """Process-unique identity token (never reused, unlike ``id()``)."""
        return self._uid

    @property
    def version(self) -> int:
        return self._version

    # ----------------------------------------------------- mutation log
    def _note(self, kind: str, ident) -> None:
        """Append one typed mutation entry and advance the version."""
        self._log.append((kind, ident))
        if len(self._log) > _LOG_CAP:
            drop = len(self._log) - _LOG_CAP // 2
            del self._log[:drop]
            self._log_base += drop
        self._version += 1
        self._clean = False
        if kind == "link":
            self._link_lookup = None
        elif kind == "nic" and self._nic_lookup is not None:
            # The NIC table is dense per node: patch the entry in place
            # (the dict is already updated when _note fires).
            self._nic_lookup[ident] = self.nic_mult.get(ident, 1.0)

    def _note_device(self, idx: int) -> None:
        if self._compute[idx] == 1.0 and self._host[idx] == 1.0:
            self._degraded.discard(idx)
        else:
            self._degraded.add(idx)
        self._note("dev", idx)

    def _bump(self) -> None:
        """Legacy whole-state invalidation (kept for external callers):
        advances the version with an untyped entry, which readers must
        treat as everything-dirty."""
        self._note("all", None)

    def cursor(self) -> int:
        """Current mutation-log position; pass to :meth:`dirty_since`."""
        return self._version

    def dirty_since(self, cursor: int) -> DirtySet:
        """Aggregate the typed mutations since ``cursor`` (see
        :class:`DirtySet`). A cursor older than the retained log window —
        or from before this state existed — yields ``full=True``."""
        if cursor >= self._version:
            return _EMPTY_DIRTY
        start = cursor - self._log_base
        if start < 0:
            return _FULL_DIRTY
        devices: set[int] = set()
        links: set[tuple[int, int]] = set()
        nics: set[int] = set()
        for kind, ident in self._log[start:]:
            if kind == "dev":
                devices.add(ident)
            elif kind == "link":
                links.add(ident)
            elif kind == "nic":
                nics.add(ident)
            else:  # legacy _bump
                return _FULL_DIRTY
        return DirtySet(
            devices=frozenset(devices),
            links=frozenset(links),
            nics=frozenset(nics),
        )

    def reset(self) -> None:
        """Restore full health, dirtying only what was actually degraded
        (per-component entries, not a whole-state invalidation — the
        injector's reset/reapply cycle stays event-scoped)."""
        if self._clean:
            return
        for i in sorted(self._degraded):
            self._compute[i] = 1.0
            self._host[i] = 1.0
            self._note("dev", i)
        self._degraded.clear()
        for key in list(self.link_mult):
            self._note("link", key)
        for node in list(self.nic_mult):
            self._note("nic", node)
        dict.clear(self.link_mult)
        dict.clear(self.nic_mult)
        # The notes above ran against the still-populated dicts; drop the
        # memoized lookups outright rather than patching stale entries.
        self._link_lookup = None
        self._nic_lookup = None
        self._clean = True

    def effective_speed(self, device: int) -> float:
        return float(self._compute[device] * self._host[device])

    def effective_speeds(self) -> np.ndarray:
        """Per-device effective speed vector (compute x host)."""
        return self._compute * self._host

    def link_bw(self, a: int, b: int) -> float:
        base = self.spec.base_link_bw(a, b)
        key = (min(a, b), max(a, b))
        bw = base * self.link_mult.get(key, 1.0)
        na, nb = self.spec.node_of(a), self.spec.node_of(b)
        if na != nb:
            bw *= min(self.nic_mult.get(na, 1.0), self.nic_mult.get(nb, 1.0))
        return bw

    def link_bw_many(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`link_bw` over parallel device-index arrays.

        Applies the exact same operation chain per element (base, then the
        link multiplier, then the NIC factor), so results match the scalar
        path bit for bit; degraded links/NICs are applied as sparse masks —
        O(len + #degraded) instead of a Python loop per edge.
        """
        spec = self.spec
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        na = a // spec.gpus_per_node
        nb = b // spec.gpus_per_node
        cross = na != nb
        bw = np.where(cross, spec.inter_node_bw, spec.intra_node_bw)
        bw = np.where(a == b, np.inf, bw)
        if self.link_mult:
            # One sorted-key lookup for all degraded links: O(len log m),
            # not a full-length mask per degraded link. The sorted tables
            # are memoized on the state until the next link mutation.
            n = spec.n_devices
            keys = np.minimum(a, b) * n + np.maximum(a, b)
            if self._link_lookup is None:
                items = sorted(
                    (klo * n + khi, mult)
                    for (klo, khi), mult in self.link_mult.items()
                )
                self._link_lookup = (
                    np.array([k for k, _ in items], dtype=np.int64),
                    np.array([m for _, m in items]),
                )
            dk, dm = self._link_lookup
            pos = np.minimum(np.searchsorted(dk, keys), dk.size - 1)
            hit = dk[pos] == keys
            if hit.any():
                bw = np.where(hit, bw * dm[pos], bw)
        if self.nic_mult:
            if self._nic_lookup is None:
                nm = np.ones(spec.n_nodes)
                for node, mult in self.nic_mult.items():
                    nm[node] = mult
                self._nic_lookup = nm
            nm = self._nic_lookup
            factor = np.minimum(nm[na], nm[nb])
            bw = np.where(cross, bw * factor, bw)
        return bw

    def degrade_link(self, a: int, b: int, mult: float) -> None:
        self.link_mult[(min(a, b), max(a, b))] = mult

    def restore_link(self, a: int, b: int) -> None:
        self.link_mult.pop((min(a, b), max(a, b)), None)

    def degrade_nic(self, node: int, mult: float) -> None:
        self.nic_mult[node] = mult

    def restore_nic(self, node: int) -> None:
        self.nic_mult.pop(node, None)
