"""Fused BOCD screening step — the port of :mod:`repro.kernels.bocd_step`.

One call advances the run-length posterior of B streams by one tick over
fixed-slot (K, B) state: predict / normalize / truncate, the shared
``max_hypotheses`` frontier as a victim pick over all columns, the
Normal-Gamma update and the renormalize. :func:`bocd_step` launches the
hand-written CUDA kernel ``csrc/bocd_step.cu`` for tensors on the card and
runs :func:`bocd_step_reference`, the same math in plain PyTorch, for
tensors on the CPU.

Fixed-slot frontier (as in the reference): exactly ``K = max_hypotheses``
slots; each tick the **victim** slot — lowest shared strength
``max_b log_r[k, b]``, ties to the smallest run length, then the smallest
slot — is overwritten by the new ``r = 0`` hypothesis. Fully dead slots
(strength ``-inf``) are recycled first; NaN strengths count as ``+inf`` so
a poisoned column never hijacks the frontier. Every column is renormalized
after the overwrite.

:class:`TorchBOCD` and :class:`CudaBOCD` put the step behind the
``ScreeningBackend`` interface (the twins of ``PallasBOCD``). State stays on
the device; only (B,) vectors come back to the host.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.convert import bocd_state_from_numpy
from repro_torch.core.bocd import DEFAULT_CP_THRESHOLD
from repro_torch.device import resolve_device
from repro_torch.kernels import _build

#: default frontier when the caller passes ``max_hypotheses=None`` — the
#: fixed-slot step needs *some* static K (uncapped growth is a numpy-backend
#: feature; 64 comfortably covers the fleet screen's caps).
DEFAULT_SLOTS = 64

_FLOAT_TYPES = (torch.float32, torch.float64)


def _const(v, dt, dev) -> torch.Tensor:
    """A 0-d tensor of ``v`` rounded once to ``dt`` (the reference's
    ``jnp.asarray(v, dt)``), filled on the device: no host synchronisation."""
    return torch.full((), float(v), dtype=dt, device=dev)


def _prep(x, log_r, alpha, mu0, hazard, alpha0, truncation):
    """The scalar prologue: gammaln constants and log-hazards in the state's
    type (the CUDA kernel computes the same per block)."""
    dt, dev = log_r.dtype, log_r.device
    df = 2.0 * alpha.to(dt)
    tconst = torch.lgamma((df + 1.0) / 2.0) - torch.lgamma(df / 2.0)
    a0 = _const(alpha0, dt, dev)
    cp_const = torch.lgamma((2.0 * a0 + 1.0) / 2.0) - torch.lgamma(a0)
    hz = _const(hazard, dt, dev)
    log_h = torch.log(hz)
    log_1mh = torch.log1p(-hz)
    log_trunc = torch.log(_const(truncation, dt, dev))
    x = x.to(dt).reshape(1, -1)
    mu0 = mu0.to(dt).reshape(1, -1)
    return x, mu0, tconst, log_h, log_1mh, log_trunc, cp_const


def bocd_step_reference(
    x, log_r, mu, beta, kappa, alpha, rl, mu0,
    hazard, kappa0=1.0, alpha0=1.0, beta0=1.0, truncation=1e-6,
):
    """One fixed-slot BOCD step in plain PyTorch, on any device.

    Shapes: ``x``/``mu0`` (B,) or (1, B) (cast to the state's type);
    ``log_r``/``mu``/``beta`` (K, B); ``kappa``/``alpha`` (K, 1); ``rl``
    (K, 1) int32. Returns ``(log_r, mu, beta, kappa, alpha, rl, p0)`` with
    ``p0`` (1, B) = Pr(r_t = 0) per stream.
    """
    dt, dev = log_r.dtype, log_r.device
    k_slots = log_r.shape[0]
    x, mu0, tconst, log_h, log_1mh, log_trunc, cp_const = _prep(
        x, log_r, alpha, mu0, hazard, alpha0, truncation
    )
    kappa0 = _const(kappa0, dt, dev)
    alpha0 = _const(alpha0, dt, dev)
    beta0 = _const(beta0, dt, dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    inf = _const(math.inf, dt, dev)
    # Growth: Student-t posterior predictive per slot.
    df = 2.0 * alpha
    scale2 = beta * ((kappa + 1.0) / (alpha * kappa))
    d = x - mu
    z2 = d * d / scale2 / df
    logpred = tconst - 0.5 * torch.log(math.pi * df * scale2)
    logpred = logpred - 0.5 * (df + 1.0) * torch.log1p(z2)
    growth = logpred + log_r + log_1mh  # dead (-inf) slots stay dead
    # Change-point row: x scored under the fresh-segment prior.
    df0 = 2.0 * alpha0
    s20 = beta0 * (kappa0 + 1.0) / (alpha0 * kappa0)
    d0 = x - mu0
    z20 = d0 * d0 / s20 / df0
    cp = cp_const - 0.5 * torch.log(math.pi * df0 * s20)
    cp = cp - 0.5 * (df0 + 1.0) * torch.log1p(z20)
    cp = cp + log_h
    # Normalize over the K + 1 conceptual rows (K grown slots + cp row).
    m = torch.maximum(torch.amax(growth, dim=0, keepdim=True), cp)
    shift = torch.where(torch.isfinite(m), m, zero)
    tot = torch.sum(torch.exp(growth - shift), dim=0, keepdim=True)
    tot = tot + torch.exp(cp - shift)
    lse = torch.log(tot) + shift
    growth = growth - lse
    cp = cp - lse
    # Per-column mass truncation (the cp row is exempt).
    growth = torch.where(growth <= log_trunc, -inf, growth)
    # Victim slot: lowest shared strength, ties -> smallest run length, then
    # smallest slot; NaN strengths count as +inf.
    strength = torch.amax(growth, dim=1, keepdim=True)
    key = torch.where(torch.isnan(strength), inf, strength)
    smin = torch.amin(key)
    rl_f = rl.to(dt)
    tie = key == smin
    rmin = torch.amin(torch.where(tie, rl_f, inf))
    victim = tie & (rl_f == rmin)
    rows = torch.arange(k_slots, dtype=torch.int32, device=dev).reshape(k_slots, 1)
    first = torch.amin(torch.where(victim, rows, torch.full_like(rows, k_slots)))
    victim = rows == first  # (K, 1) one-hot
    # Normal-Gamma update: survivors advance; the victim restarts from the
    # prior and absorbs x as its first observation.
    kap = torch.where(victim, kappa0, kappa)
    alp = torch.where(victim, alpha0, alpha)
    mu_b = torch.where(victim, mu0, mu)
    beta_b = torch.where(victim, beta0, beta)
    denom = kap + 1.0
    d = x - mu_b
    beta_out = beta_b + 0.5 * kap * (d * d) / denom
    mu_out = (kap * mu_b + x) / denom
    alpha_out = alp + 0.5
    rl_out = torch.where(victim, torch.zeros_like(rl), rl + 1)
    log_r_new = torch.where(victim, cp, growth)
    # Renormalize every column.
    m2 = torch.amax(log_r_new, dim=0, keepdim=True)
    shift2 = torch.where(torch.isfinite(m2), m2, zero)
    lse2 = torch.log(
        torch.sum(torch.exp(log_r_new - shift2), dim=0, keepdim=True)
    ) + shift2
    log_r_out = log_r_new - lse2
    p0 = torch.sum(
        torch.where(victim, torch.exp(log_r_out), zero), dim=0, keepdim=True
    )
    return log_r_out, mu_out, beta_out, denom, alpha_out, rl_out, p0


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"bocd_step: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"bocd_step: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"bocd_step: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"bocd_step: {name} must be contiguous")


_p, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: C signature of ``bocd_step_f32`` / ``bocd_step_f64``
_ARGTYPES = (
    [_p] * 8 + [_i, _i] + [_d] * 5 + [_p] * 8 + [ctypes.c_longlong] + [_p, _p, _p]
)
_SYMBOL = {torch.float32: "bocd_step_f32", torch.float64: "bocd_step_f64"}


@functools.cache
def _threads() -> int:
    """Threads per block of the column passes (a constant of the library)."""
    return _build.entry("bocd_step", "bocd_step_threads", [])()


def bocd_step(
    x, log_r, mu, beta, kappa, alpha, rl, mu0,
    hazard, kappa0=1.0, alpha0=1.0, beta0=1.0, truncation=1e-6,
):
    """One fused step: the CUDA kernel (three launches on the current
    stream) for tensors on the card, :func:`bocd_step_reference` for tensors
    on the CPU. Same arguments and results as the reference; ``x`` and
    ``mu0`` are cast to the state's type as the reference does."""
    if log_r.device.type == "cpu":
        return bocd_step_reference(
            x, log_r, mu, beta, kappa, alpha, rl, mu0,
            hazard, kappa0, alpha0, beta0, truncation,
        )
    if log_r.device.type != "cuda":
        raise ValueError(f"bocd_step: unsupported device {log_r.device}")
    dt, dev = log_r.dtype, log_r.device
    if dt not in _FLOAT_TYPES:
        raise ValueError(f"bocd_step: dtype {dt} is not float32/float64")
    k, b = log_r.shape
    if k < 1 or b < 1:
        raise ValueError(f"bocd_step: empty state of shape {(k, b)}")
    x = x.to(dt).reshape(b).contiguous()
    mu0 = mu0.to(dt).reshape(b).contiguous()
    _check("x", x, (b,), dt, dev)
    _check("mu0", mu0, (b,), dt, dev)
    _check("log_r", log_r, (k, b), dt, dev)
    _check("mu", mu, (k, b), dt, dev)
    _check("beta", beta, (k, b), dt, dev)
    _check("kappa", kappa, (k, 1), dt, dev)
    _check("alpha", alpha, (k, 1), dt, dev)
    _check("rl", rl, (k, 1), torch.int32, dev)
    fn = _build.entry("bocd_step", _SYMBOL[dt], _ARGTYPES)
    nblk = -(-b // _threads())
    log_r_out = torch.empty((k, b), dtype=dt, device=dev)
    mu_out = torch.empty((k, b), dtype=dt, device=dev)
    beta_out = torch.empty((k, b), dtype=dt, device=dev)
    kappa_out = torch.empty((k, 1), dtype=dt, device=dev)
    alpha_out = torch.empty((k, 1), dtype=dt, device=dev)
    rl_out = torch.empty((k, 1), dtype=torch.int32, device=dev)
    p0 = torch.empty((1, b), dtype=dt, device=dev)
    partial = torch.empty((nblk, k), dtype=dt, device=dev)   # scratch
    cp_norm = torch.empty((b,), dtype=dt, device=dev)        # scratch
    victim = torch.empty((1,), dtype=torch.int32, device=dev)  # scratch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            x.data_ptr(), log_r.data_ptr(), mu.data_ptr(), beta.data_ptr(),
            kappa.data_ptr(), alpha.data_ptr(), rl.data_ptr(), mu0.data_ptr(),
            k, b, float(hazard), float(kappa0), float(alpha0), float(beta0),
            float(truncation), log_r_out.data_ptr(), mu_out.data_ptr(),
            beta_out.data_ptr(), kappa_out.data_ptr(), alpha_out.data_ptr(),
            rl_out.data_ptr(), p0.data_ptr(), partial.data_ptr(),
            partial.numel(), cp_norm.data_ptr(), victim.data_ptr(), stream,
        )
    _build.check("bocd_step", err)
    bocd_step.launches += 1
    return log_r_out, mu_out, beta_out, kappa_out, alpha_out, rl_out, p0


#: fused steps launched through :func:`bocd_step` (each is three CUDA
#: launches on one stream; CPU calls are not counted)
bocd_step.launches = 0


def _logsumexp_cols_t(a: torch.Tensor) -> torch.Tensor:
    """Column-wise logsumexp of a (K, B) tensor; all ``-inf`` columns ->
    ``-inf`` (the torch twin of ``core.bocd._logsumexp_cols``)."""
    m = torch.amax(a, dim=0)
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.sum(torch.exp(a - shift), dim=0)) + shift


class TorchBOCD:
    """Fixed-slot batched BOCD screening backend stepped by the plain
    PyTorch version (:func:`bocd_step_reference`) on any device.

    Drop-in for :class:`repro_torch.core.bocd.BatchedBOCD` behind the
    ``ScreeningBackend`` interface (``update`` / ``p_recent_change`` /
    ``map_runlength`` / ``take_columns`` / ``retune``, plus ``snapshot`` /
    ``restore``). State lives on ``device`` as tensors of ``dtype``
    (float64 by default: the plain path is the tight-parity oracle); the
    posterior statistics are reduced on the device and only (B,) vectors are
    copied back.
    """

    name = "torch"
    default_dtype = torch.float64

    def __init__(
        self,
        n_series: int,
        hazard: float = 1.0 / 100.0,
        mu0: float | np.ndarray = 0.0,
        kappa0: float = 1.0,
        alpha0: float = 1.0,
        beta0: float = 1.0,
        cp_threshold: float = DEFAULT_CP_THRESHOLD,
        truncation: float = 1e-6,
        max_hypotheses: int | None = 32,
        *,
        device=None,
        dtype: torch.dtype | None = None,
    ) -> None:
        b = int(n_series)
        k = DEFAULT_SLOTS if max_hypotheses is None else int(max_hypotheses)
        if k < 2:
            raise ValueError(f"{type(self).__name__} needs at least 2 hypothesis slots")
        self.device = resolve_device(device)
        self.dtype = self.default_dtype if dtype is None else dtype
        self.n_series = b
        self.hazard = float(hazard)
        self.kappa0 = float(kappa0)
        self.alpha0 = float(alpha0)
        self.beta0 = float(beta0)
        self.cp_threshold = float(cp_threshold)
        self.truncation = float(truncation)
        self.max_hypotheses = k
        mu0 = np.broadcast_to(np.asarray(mu0, dtype=np.float64), (b,))
        self._mu0 = self._tensor(mu0)
        # Slot 0 holds the prior hypothesis; slots 1..K-1 start dead (-inf
        # mass) and are recycled as the frontier fills.
        log_r = np.full((k, b), -np.inf)
        log_r[0] = 0.0
        self._log_r = self._tensor(log_r)
        self._mu = self._mu0[None, :].expand(k, b).contiguous()
        self._beta = torch.full((k, b), beta0, dtype=self.dtype, device=self.device)
        self._kappa = torch.full((k, 1), kappa0, dtype=self.dtype, device=self.device)
        self._alpha = torch.full((k, 1), alpha0, dtype=self.dtype, device=self.device)
        self._rl = torch.zeros((k, 1), dtype=torch.int32, device=self.device)
        self._t = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    _step = staticmethod(bocd_step_reference)

    # -- ScreeningBackend interface ------------------------------------
    @property
    def n_hypotheses(self) -> int:
        return int(torch.isfinite(self._log_r).any(dim=1).sum())

    def update(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (self.n_series,):
            raise ValueError(f"expected shape ({self.n_series},), got {x.shape}")
        (self._log_r, self._mu, self._beta, self._kappa, self._alpha,
         self._rl, p0) = self._step(
            self._tensor(x), self._log_r, self._mu, self._beta,
            self._kappa, self._alpha, self._rl, self._mu0,
            self.hazard, self.kappa0, self.alpha0, self.beta0,
            self.truncation,
        )
        self._t += 1
        return p0[0].to(torch.float64).cpu().numpy()

    def p_recent_change(self, window: int = 2) -> np.ndarray:
        # Rows with run length <= window, in float64 on the device; a
        # masked-out row contributes exp(-inf) = 0, and no recent row at all
        # gives zeros, as the reference's early return does.
        recent = self._rl <= window  # (K, 1)
        lr = torch.where(
            recent, self._log_r.to(torch.float64),
            torch.full((), -math.inf, dtype=torch.float64, device=self.device),
        )
        return torch.exp(_logsumexp_cols_t(lr)).cpu().numpy()

    def map_runlength(self) -> np.ndarray:
        idx = torch.argmax(self._log_r, dim=0)
        return self._rl[:, 0].to(torch.int64)[idx].cpu().numpy()

    def take_columns(self, idx: np.ndarray) -> None:
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.device)
        self.n_series = int(idx.numel())
        self._mu0 = self._mu0[idx]
        self._log_r = self._log_r[:, idx].contiguous()
        self._mu = self._mu[:, idx].contiguous()
        self._beta = self._beta[:, idx].contiguous()

    def retune(
        self,
        hazard: float | None = None,
        max_hypotheses: int | None = None,
    ) -> None:
        if hazard is not None:
            self.hazard = float(hazard)
        if max_hypotheses is None or max_hypotheses == self.max_hypotheses:
            return
        # Resize the slot frontier: keep the strongest rows (ties to the
        # smallest run length / slot, like the per-tick victim rule), pad
        # with dead slots when growing. Only (K,) vectors leave the device.
        k_new = int(max_hypotheses)
        k, b = self._log_r.shape
        if k_new < k:
            lr = self._log_r.to(torch.float64)
            strength = torch.where(
                torch.isnan(lr).any(dim=1),
                torch.full((k,), -math.inf, dtype=torch.float64, device=self.device),
                torch.amax(lr, dim=1),
            ).cpu().numpy()
            rl = self._rl[:, 0].cpu().numpy()
            order = np.lexsort((np.arange(k), -rl, -strength))
            sel = torch.as_tensor(np.sort(order[:k_new]), device=self.device)
            self._log_r = self._log_r[sel]
            self._mu = self._mu[sel]
            self._beta = self._beta[sel]
            self._kappa = self._kappa[sel]
            self._alpha = self._alpha[sel]
            self._rl = self._rl[sel]
        elif k_new > k:
            pad = k_new - k
            full = lambda shape, v, dt=self.dtype: torch.full(  # noqa: E731
                shape, v, dtype=dt, device=self.device
            )
            self._log_r = torch.cat([self._log_r, full((pad, b), -math.inf)])
            self._mu = torch.cat([self._mu, full((pad, b), 0.0)])
            self._beta = torch.cat([self._beta, full((pad, b), self.beta0)])
            self._kappa = torch.cat([self._kappa, full((pad, 1), self.kappa0)])
            self._alpha = torch.cat([self._alpha, full((pad, 1), self.alpha0)])
            self._rl = torch.cat([self._rl, full((pad, 1), 0, torch.int32)])
        self.max_hypotheses = k_new

    # -- state capture (fleet snapshot / restore contract) ----------------
    def snapshot(self) -> dict:
        """Full slot state as host numpy copies (``layout == "slots"``)."""
        host = lambda t: t.cpu().numpy().copy()  # noqa: E731
        return {
            "layout": "slots",
            "n_series": self.n_series,
            "hazard": self.hazard,
            "max_hypotheses": self.max_hypotheses,
            "mu0": host(self._mu0),
            "log_r": host(self._log_r),
            "mu": host(self._mu),
            "beta": host(self._beta),
            "kappa": host(self._kappa),
            "alpha": host(self._alpha),
            "rl": host(self._rl),
            "t": self._t,
        }

    def restore(self, snap: dict) -> None:
        """Reinstate a slot-layout :meth:`snapshot` (see
        :func:`repro_torch.convert.fleet_snapshot_from_reference` for the
        reference's row-layout ``BatchedBOCD`` snapshots)."""
        if snap.get("layout") != "slots":
            raise ValueError(
                "expected a slot-layout snapshot; convert BatchedBOCD "
                "snapshots with repro_torch.convert first"
            )
        state = bocd_state_from_numpy(snap, self.device, self.dtype)
        self.n_series = int(snap["n_series"])
        self.hazard = float(snap["hazard"])
        self.max_hypotheses = int(snap["max_hypotheses"])
        self._log_r = state["log_r"]
        self._mu = state["mu"]
        self._beta = state["beta"]
        self._kappa = state["kappa"]
        self._alpha = state["alpha"]
        self._rl = state["rl"]
        self._mu0 = state["mu0"]
        self._t = int(snap["t"])


class CudaBOCD(TorchBOCD):
    """The fixed-slot backend stepped by the CUDA kernel (:func:`bocd_step`)
    — the twin of ``PallasBOCD``. ``dtype`` defaults to float32, the
    accelerator's width; on a CPU device the wrapper runs the plain version.
    """

    name = "cuda"
    default_dtype = torch.float32

    _step = staticmethod(bocd_step)
