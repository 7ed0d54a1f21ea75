"""Bayesian Online Change-point Detection (paper §4.2 + Appendix 9.1).

Implements the Adams/MacKay-style run-length recursion the paper uses
(eqs. 2-5): at each step maintain the run-length posterior Pr(r_t | x_{1:t}),
with a Normal-Gamma underlying probabilistic model (Student-t predictive) and
a constant-hazard change-point prior. A timestamp t is reported as a
change-point when Pr(r_t = 0 | x_{1:t}) exceeds a threshold (0.9 in the
paper's experiments). Time and memory are kept linear by truncating
negligible run-length mass.

Fast-path architecture (fleet scale)
------------------------------------
Two implementations share the recursion:

* :class:`BOCD` — one scalar series. Sufficient statistics live in
  capacity-doubling buffers that are shifted and updated **in place**, so an
  update allocates O(1) small temporaries instead of re-concatenating the
  prior onto every array (the seed did four ``np.concatenate`` per
  observation).
* :class:`BatchedBOCD` — B independent series advanced in lockstep as 2-D
  ``(K, B)`` array operations: one vectorized Student-t log-predictive, one
  per-column normalization, one shared truncation frontier per tick. Row
  ``i`` holds the run-length-``rl[i]`` hypothesis of *every* series; a
  ``-inf`` posterior entry marks a hypothesis that one series has truncated
  while another still tracks it. Rows dead in every column are compacted
  away, bounding K exactly like the scalar truncation. Per column the
  posterior (and therefore the change-point indices) matches the scalar
  recursion — :class:`repro_torch.core.detector.FleetDetect` relies on this to
  screen thousands of workers per tick and escalate only flagged ones.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np

DEFAULT_CP_THRESHOLD = 0.9

_MIN_CAPACITY = 64


@dataclass
class BOCD:
    """Online change-point detector over a scalar series (iteration times).

    Parameters mirror the standard Normal-Gamma conjugate prior:
      mu0/kappa0: prior mean and its pseudo-count,
      alpha0/beta0: precision-Gamma shape/rate,
      hazard: constant change-point hazard rate 1/expected-run-length.
    """

    hazard: float = 1.0 / 100.0
    mu0: float = 0.0
    kappa0: float = 1.0
    alpha0: float = 1.0
    beta0: float = 1.0
    cp_threshold: float = DEFAULT_CP_THRESHOLD
    truncation: float = 1e-6
    #: optional hard bound on run-length hypotheses (fleet fast path): after
    #: mass truncation, keep r=0 plus the top ``max_hypotheses - 1`` rows by
    #: posterior mass (stable tie-break on run length). None = paper-exact.
    max_hypotheses: int | None = None

    # --- state: views of length _len into the capacity buffers below ---
    _log_r: np.ndarray = field(init=False)
    _mu: np.ndarray = field(init=False)
    _kappa: np.ndarray = field(init=False)
    _alpha: np.ndarray = field(init=False)
    _beta: np.ndarray = field(init=False)
    _rl: np.ndarray = field(init=False)
    _t: int = field(init=False, default=0)
    _len: int = field(init=False, default=1)

    def __post_init__(self) -> None:
        cap = _MIN_CAPACITY
        self._log_r_buf = np.zeros(cap)
        self._mu_buf = np.empty(cap)
        self._kappa_buf = np.empty(cap)
        self._alpha_buf = np.empty(cap)
        self._beta_buf = np.empty(cap)
        self._rl_buf = np.zeros(cap, dtype=np.int64)
        self._mu_buf[0] = self.mu0
        self._kappa_buf[0] = self.kappa0
        self._alpha_buf[0] = self.alpha0
        self._beta_buf[0] = self.beta0
        self._refresh_views()

    def _refresh_views(self) -> None:
        n = self._len
        self._log_r = self._log_r_buf[:n]
        self._mu = self._mu_buf[:n]
        self._kappa = self._kappa_buf[:n]
        self._alpha = self._alpha_buf[:n]
        self._beta = self._beta_buf[:n]
        self._rl = self._rl_buf[:n]

    def _grow(self) -> None:
        cap = 2 * self._log_r_buf.size
        for name in ("_log_r_buf", "_mu_buf", "_kappa_buf", "_alpha_buf",
                     "_beta_buf", "_rl_buf"):
            old = getattr(self, name)
            buf = np.empty(cap, dtype=old.dtype)
            buf[: old.size] = old
            setattr(self, name, buf)

    # ------------------------------------------------------------------
    def _log_pred(self, x: float) -> np.ndarray:
        """Student-t log predictive for each current run-length hypothesis."""
        return _student_t_logpdf(x, self._mu, self._kappa, self._alpha, self._beta)

    def _log_prior_pred(self, x: float) -> float:
        """Student-t log predictive under the (fresh-segment) prior."""
        return float(
            _student_t_logpdf(
                x,
                np.array([self.mu0]),
                np.array([self.kappa0]),
                np.array([self.alpha0]),
                np.array([self.beta0]),
            )[0]
        )

    def update(self, x: float) -> float:
        """Feed one observation; return Pr(r_t = 0 | x_{1:t}).

        Convention: ``r_t = 0`` means x_t is the *first* observation of a new
        segment, so the change-point path scores x_t under the **prior**
        predictive while growth paths score it under each run's posterior
        predictive. (In the alternative Adams-MacKay message convention the
        CP path reuses the old run's predictive and Pr(r_t=0) degenerates to
        the hazard whenever predictives coincide — useless for the paper's
        "probability > 0.9" detection rule.)
        """
        n = self._len
        if n + 1 > self._log_r_buf.size:
            self._grow()
        log_h = math.log(self.hazard)
        log_1mh = math.log1p(-self.hazard)

        # Growth probabilities: run continues (r -> r+1).
        log_growth = self._log_pred(x)
        log_growth += self._log_r
        log_growth += log_1mh
        # Change-point: new segment begins at t; x_t scored under the prior.
        log_cp = self._log_prior_pred(x) + log_h  # sum_r P(r) = 1 (normalized)

        lr = self._log_r_buf
        lr[1 : n + 1] = log_growth
        lr[0] = log_cp
        new_log_r = lr[: n + 1]
        new_log_r -= _logsumexp(new_log_r)

        # Shift the sufficient statistics one slot (the new r=0 hypothesis is
        # the prior) and apply the Normal-Gamma update in place.
        for buf, prior in (
            (self._mu_buf, self.mu0),
            (self._kappa_buf, self.kappa0),
            (self._alpha_buf, self.alpha0),
            (self._beta_buf, self.beta0),
        ):
            buf[1 : n + 1] = buf[:n]
            buf[0] = prior
        mu = self._mu_buf[: n + 1]
        kappa = self._kappa_buf[: n + 1]
        denom = kappa + 1.0
        upd = 0.5 * kappa
        upd *= (x - mu) ** 2
        upd /= denom
        self._beta_buf[: n + 1] += upd
        mu *= kappa
        mu += x
        mu /= denom
        kappa += 1.0
        self._alpha_buf[: n + 1] += 0.5
        rl = self._rl_buf
        rl[1 : n + 1] = rl[:n]
        rl[1 : n + 1] += 1
        rl[0] = 0
        self._len = n + 1
        self._t += 1

        # Truncate negligible run-length mass -> linear time overall (R2).
        keep = new_log_r > math.log(self.truncation)
        keep[0] = True
        if not keep.all():
            self._compact(np.flatnonzero(keep))
        cap = self.max_hypotheses
        if cap is not None and self._len > cap:
            lr = self._log_r_buf[: self._len]
            order = np.argsort(lr[1:], kind="stable")  # ascending mass
            keep = np.ones(self._len, dtype=bool)
            keep[order[: self._len - cap] + 1] = False
            self._compact(np.flatnonzero(keep))
        self._refresh_views()
        return float(math.exp(self._log_r[0]))

    def _compact(self, idx: np.ndarray) -> None:
        """Keep only hypothesis rows ``idx`` (ascending) and renormalize."""
        m = idx.size
        n = self._len
        for buf in (self._log_r_buf, self._mu_buf, self._kappa_buf,
                    self._alpha_buf, self._beta_buf, self._rl_buf):
            buf[:m] = buf[:n][idx]
        self._len = m
        self._log_r_buf[:m] -= _logsumexp(self._log_r_buf[:m])

    def retune(
        self,
        hazard: float | None = None,
        max_hypotheses: int | None = None,
    ) -> None:
        """Adjust the change-point prior / frontier cap mid-stream.

        Both only affect *future* updates (the hazard enters each step's
        growth/change mixture; the cap is applied per update), so the
        adaptive screening layer can re-derive them from observed change
        rates without rebuilding run-length state."""
        if hazard is not None:
            self.hazard = hazard
        if max_hypotheses is not None:
            self.max_hypotheses = max_hypotheses

    # -- detection statistics ------------------------------------------
    def p_recent_change(self, window: int = 2) -> float:
        """Posterior probability that a change-point occurred within the
        last ``window`` observations: Pr(r_t <= window | x_{1:t})."""
        # _rl is strictly increasing, so the recent rows are a prefix.
        j = int(np.searchsorted(self._rl, window, side="right"))
        if j == 0:
            return 0.0
        return float(np.exp(_logsumexp(self._log_r[:j])))

    def map_runlength(self) -> int:
        """MAP run length (distance back to the most likely change-point)."""
        return int(self._rl[int(np.argmax(self._log_r))])


class BatchedBOCD:
    """B independent BOCD recursions advanced in lockstep (fleet fast path).

    All state is ``(K, B)``: row ``i`` holds the run-length-``rl[i]``
    hypothesis of every series. Per-column truncation marks a series'
    negligible hypotheses with ``-inf`` posterior (they can never revive:
    growth adds finite log-predictives to ``-inf``); the shared frontier
    compacts rows that are dead in **every** column, so K stays bounded
    exactly like the scalar detector's. Each series' posterior matches the
    scalar :class:`BOCD` recursion step for step.
    """

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
        max_hypotheses: int | None = None,
    ) -> None:
        b = int(n_series)
        self.n_series = b
        self.hazard = hazard
        self.kappa0 = kappa0
        self.alpha0 = alpha0
        self.beta0 = beta0
        self.cp_threshold = cp_threshold
        self.truncation = truncation
        self.max_hypotheses = max_hypotheses
        self._mu0 = np.broadcast_to(
            np.asarray(mu0, dtype=np.float64), (b,)
        ).copy()
        self._log_r = np.zeros((1, b))
        self._mu = self._mu0[None, :].copy()
        self._beta = np.full((1, b), beta0)
        # kappa/alpha receive the same +1.0/+0.5 per step in every column
        # (shared prior, lockstep updates), so they are row-constant: store
        # them once per run-length hypothesis, not per series. This keeps the
        # expensive gammaln terms of the Student-t at O(K) instead of O(K*B).
        self._kappa_row = np.full(1, kappa0)
        self._alpha_row = np.full(1, alpha0)
        self._rl = np.zeros(1, dtype=np.int64)
        self._t = 0

    @property
    def n_hypotheses(self) -> int:
        return self._rl.size

    def take_columns(self, idx: np.ndarray) -> None:
        """Sub-slice the batch to the series in ``idx`` (dynamic membership).

        Columns are statistically independent — truncation in uncapped mode
        is per-column, and the shared ``max_hypotheses`` frontier only
        couples which *rows* survive — so each kept column's posterior is
        carried over unchanged: in uncapped mode it is exactly what a fresh
        recursion over that column alone would hold. Hypothesis rows now
        dead in every surviving column are compacted away, shrinking the
        frontier like the per-tick truncation does.
        """
        idx = np.asarray(idx, dtype=np.int64)
        self.n_series = int(idx.size)
        self._mu0 = self._mu0[idx]
        self._log_r = self._log_r[:, idx]
        self._mu = self._mu[:, idx]
        self._beta = self._beta[:, idx]
        alive = np.isfinite(self._log_r).any(axis=1)
        if alive.size:
            alive[0] = True
        if not alive.all():
            self._log_r = self._log_r[alive]
            self._mu = self._mu[alive]
            self._beta = self._beta[alive]
            self._kappa_row = self._kappa_row[alive]
            self._alpha_row = self._alpha_row[alive]
            self._rl = self._rl[alive]

    def update(self, x: np.ndarray) -> np.ndarray:
        """Feed one observation per series; return Pr(r_t = 0) per series."""
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (self.n_series,):
            raise ValueError(f"expected shape ({self.n_series},), got {x.shape}")
        log_h = math.log(self.hazard)
        log_1mh = math.log1p(-self.hazard)

        log_growth = _student_t_logpdf_rows(
            x, self._mu, self._kappa_row, self._alpha_row, self._beta
        )
        log_growth += self._log_r  # -inf (dead) rows stay -inf
        log_growth += log_1mh
        log_cp = _student_t_logpdf(
            x, self._mu0, np.float64(self.kappa0), np.float64(self.alpha0),
            np.float64(self.beta0),
        )
        log_cp += log_h

        k, b = self._log_r.shape
        new_log_r = np.empty((k + 1, b))
        new_log_r[0] = log_cp
        new_log_r[1:] = log_growth
        new_log_r -= _logsumexp_cols(new_log_r)

        mu_all = np.empty((k + 1, b))
        mu_all[0] = self._mu0
        mu_all[1:] = self._mu
        beta_all = np.empty((k + 1, b))
        beta_all[0] = self.beta0
        beta_all[1:] = self._beta
        kappa_all = np.empty(k + 1)
        kappa_all[0] = self.kappa0
        kappa_all[1:] = self._kappa_row
        alpha_all = np.empty(k + 1)
        alpha_all[0] = self.alpha0
        alpha_all[1:] = self._alpha_row
        denom = kappa_all + 1.0
        # In-place chains mirror the scalar operation order exactly.
        upd = x - mu_all
        np.multiply(upd, upd, out=upd)
        upd *= (0.5 * kappa_all)[:, None]
        upd /= denom[:, None]
        beta_all += upd
        self._beta = beta_all
        mu_all *= kappa_all[:, None]
        mu_all += x
        mu_all /= denom[:, None]
        self._mu = mu_all
        self._kappa_row = denom
        self._alpha_row = alpha_all + 0.5
        rl = np.empty(k + 1, dtype=np.int64)
        rl[0] = 0
        rl[1:] = self._rl
        rl[1:] += 1
        self._rl = rl
        self._t += 1

        # Per-column truncation: kill sub-threshold live hypotheses
        # (scalar-equivalent), plus the shared truncation frontier: keep r=0
        # and the cap-1 hypothesis rows with the highest column-max mass, so
        # K stays <= cap and every per-tick array op is bounded. With B=1
        # the cap is exactly the scalar rule; for B>1 it trades per-column
        # exactness for bounded fleet cost (flagged workers re-run the exact
        # scalar path during escalation anyway). One renormalization +
        # compaction pass covers both kill sources.
        dead = new_log_r <= math.log(self.truncation)
        dead[0] = False
        dead &= np.isfinite(new_log_r)
        if dead.any():
            new_log_r[dead] = -np.inf
        cap = self.max_hypotheses
        if cap is not None and new_log_r.shape[0] > cap:
            k1 = new_log_r.shape[0]
            strength = np.max(new_log_r, axis=1)
            order = np.argsort(strength[1:], kind="stable")  # ascending
            kill = np.zeros((k1, b), dtype=bool)
            kill[order[: k1 - cap] + 1] = True
            kill &= np.isfinite(new_log_r)
            if kill.any():
                new_log_r[kill] = -np.inf
                dead |= kill
        self._log_r = self._kill(new_log_r, dead)
        return np.exp(self._log_r[0])

    def _kill(self, log_r: np.ndarray, dead: np.ndarray) -> np.ndarray:
        """Renormalize columns with ``dead`` (-inf-marked) entries and
        compact hypothesis rows that are dead in every column."""
        if not dead.any():
            return log_r
        cols = dead.any(axis=0)
        if cols.mean() > 0.5:
            # Most columns affected: renormalizing everything avoids the
            # fancy-index copies (a no-op ~0 shift for untouched columns).
            log_r -= _logsumexp_cols(log_r)
        else:
            log_r[:, cols] -= _logsumexp_cols(log_r[:, cols])
        alive = np.isfinite(log_r).any(axis=1)
        alive[0] = True
        if not alive.all():
            log_r = log_r[alive]
            self._mu = self._mu[alive]
            self._beta = self._beta[alive]
            self._kappa_row = self._kappa_row[alive]
            self._alpha_row = self._alpha_row[alive]
            self._rl = self._rl[alive]
        return log_r

    def retune(
        self,
        hazard: float | None = None,
        max_hypotheses: int | None = None,
    ) -> None:
        """Adjust the change-point prior / shared frontier cap mid-stream
        (future updates only — run-length state carries over unchanged)."""
        if hazard is not None:
            self.hazard = hazard
        if max_hypotheses is not None:
            self.max_hypotheses = max_hypotheses

    # -- detection statistics (vectorized analogues of BOCD's) ----------
    def p_recent_change(self, window: int = 2) -> np.ndarray:
        """Pr(r_t <= window | x_{1:t}) for every series, shape (B,)."""
        # _rl is strictly increasing, so the recent rows are a prefix: a
        # view slice, not a boolean-mask copy of the (K, B) posterior.
        j = int(np.searchsorted(self._rl, window, side="right"))
        if j == 0:
            return np.zeros(self.n_series)
        return np.exp(_logsumexp_cols(self._log_r[:j]))

    def map_runlength(self) -> np.ndarray:
        """MAP run length per series, shape (B,) ints."""
        return self._rl[np.argmax(self._log_r, axis=0)]

    # -- state capture (campaign fork/restore contract) ------------------
    def snapshot(self) -> dict:
        """Full posterior state as private copies (restore-many safe)."""
        return {
            "n_series": self.n_series,
            "hazard": self.hazard,
            "max_hypotheses": self.max_hypotheses,
            "mu0": self._mu0.copy(),
            "log_r": self._log_r.copy(),
            "mu": self._mu.copy(),
            "beta": self._beta.copy(),
            "kappa_row": self._kappa_row.copy(),
            "alpha_row": self._alpha_row.copy(),
            "rl": self._rl.copy(),
            "t": self._t,
        }

    def restore(self, snap: dict) -> None:
        """Reinstate a :meth:`snapshot` bit-exactly (copies again, so the
        same blob can seed any number of forks)."""
        self.n_series = snap["n_series"]
        self.hazard = snap["hazard"]
        self.max_hypotheses = snap["max_hypotheses"]
        self._mu0 = snap["mu0"].copy()
        self._log_r = snap["log_r"].copy()
        self._mu = snap["mu"].copy()
        self._beta = snap["beta"].copy()
        self._kappa_row = snap["kappa_row"].copy()
        self._alpha_row = snap["alpha_row"].copy()
        self._rl = snap["rl"].copy()
        self._t = snap["t"]


@dataclass(eq=False)
class _MultiGroup:
    """One cohort's slice of a :class:`MultiBOCD` frontier.

    ``cols`` are this group's column indices into the shared ``(K, B)``
    arrays; the group's live hypothesis rows are the prefix ``0..k-1`` (cells
    below are ``-inf``-posterior voids). ``rl`` is the group's row-constant
    run length, exactly as a standalone :class:`BatchedBOCD` would hold it;
    the row-constant ``kappa``/``alpha`` statistics are *derived* —
    ``kappa0 + (rl+1)`` steps of +1.0 / ``alpha0 + (rl+1)`` steps of +0.5 —
    and read from the owner's shared age ladders.

    ``cols`` is always a contiguous ascending range ``c0..c1-1``: absorb
    appends a fresh ``arange`` block, and column removal deletes columns
    from inside a group's own range while shifting every other group's
    block uniformly, which preserves contiguity. The range bounds are
    cached so the per-tick loops can slice (views) instead of fancy-index
    (copies).
    """

    cols: np.ndarray
    hazard: float
    cap: int | None
    k: int
    rl: np.ndarray
    #: updates this group has absorbed (the standalone batch's ``_t`` —
    #: warm replay plus fused ticks; export hands it back verbatim)
    t: int = 0
    c0: int = 0
    c1: int = 0

    def refresh_range(self) -> None:
        self.c0 = int(self.cols[0])
        self.c1 = int(self.cols[-1]) + 1
        if self.c1 - self.c0 != self.cols.size:
            raise AssertionError(
                "MultiBOCD group columns are no longer contiguous"
            )


class MultiBOCD:
    """Several independent :class:`BatchedBOCD` groups advanced in ONE fused
    per-tick pass (the multi-cohort screen, ROADMAP item 4 residual).

    :class:`repro_torch.core.detector.FleetDetect` keeps one batch per cohort, so a
    churny fleet pays the fixed cost of every small numpy op once *per
    cohort* per tick. This class holds all cohorts in shared ``(K, B)`` cell
    arrays (``K`` = largest group frontier, ``B`` = total streams) and runs
    the expensive elementwise chains — the Student-t log-predictive, the
    posterior normalization, the Normal-Gamma statistics update — once per
    tick across every group.

    Bit-exactness contract: each group's posterior is **bit-identical** to
    what its standalone :class:`BatchedBOCD` would hold. This relies on
    three properties, each covered by the equivalence tests:

    * elementwise chains are applied per cell in the exact same operation
      order as :func:`_student_t_logpdf_rows` / :meth:`BatchedBOCD.update`,
      so every cell sees the same float sequence;
    * numpy's axis-0 reductions accumulate row-sequentially for matrices
      with ``>= 2`` columns, so void rows (``exp(-inf) == 0.0``) and column
      sub-slices reduce bit-identically to the per-cohort operands;
    * single-column operands take numpy's 1-D pairwise-summation path, which
      *does* reassociate under padding — so any reduction whose per-cohort
      equivalent ran on one column is recomputed on a contiguous
      ``(k, 1)`` copy of exactly the per-cohort shape.

    Groups enter via :meth:`absorb` (adopting a warmed standalone batch) and
    are driven through :class:`MultiGroupHandle`, which implements the
    per-cohort :class:`ScreeningBackend` surface minus ``update``.
    """

    def __init__(self) -> None:
        self.kappa0 = 1.0
        self.alpha0 = 1.0
        self.beta0 = 1.0
        self.truncation = 1e-6
        self.cp_threshold = DEFAULT_CP_THRESHOLD
        self._groups: list[_MultiGroup] = []
        self._log_r = np.zeros((0, 0))
        self._mu = np.zeros((0, 0))
        self._beta = np.zeros((0, 0))
        self._mu0 = np.zeros(0)
        #: per-cell hypothesis age: the number of +1.0 kappa / +0.5 alpha
        #: prior-update steps the cell's run-length hypothesis has absorbed
        #: (live rows: rl + 1, row-constant per group; void cells just keep
        #: counting — their posterior is -inf so the values are never read).
        #: Ages index the shared ladders below, turning the per-group
        #: row-to-cell scatter of kappa/alpha/const into three gathers.
        self._age = np.zeros((0, 0), dtype=np.int64)
        self._age_hi = 0
        self._kap_lad = np.array([self.kappa0])
        self._alp_lad = np.array([self.alpha0])
        self._const_lad = _gammaln((2.0 * self._alp_lad + 1.0) / 2.0) - \
            _gammaln(2.0 * self._alp_lad / 2.0)
        #: per-column log hazard / log(1-hazard), maintained on membership
        #: and retune instead of rebuilt every tick
        self._log_h = np.zeros(0)
        self._log_1mh = np.zeros(0)
        self._t = 0

    def _ensure_ladder(self, hi: int) -> None:
        """Extend the shared kappa/alpha/const ladders to cover age ``hi``.

        Values are chained incrementally (``+1.0`` / ``+0.5`` per step from
        the prior), the exact accumulation a per-tick row update performs,
        so a ladder read is bit-identical to the incrementally maintained
        row statistic it replaces.
        """
        n0 = self._kap_lad.size
        if n0 > hi:
            return
        kl = np.empty(hi + 1)
        al = np.empty(hi + 1)
        kl[:n0] = self._kap_lad
        al[:n0] = self._alp_lad
        for j in range(n0, hi + 1):
            kl[j] = kl[j - 1] + 1.0
            al[j] = al[j - 1] + 0.5
        cl = np.empty(hi + 1)
        cl[:n0] = self._const_lad
        df = 2.0 * al[n0:]
        cl[n0:] = _gammaln((df + 1.0) / 2.0) - _gammaln(df / 2.0)
        self._kap_lad, self._alp_lad, self._const_lad = kl, al, cl

    @property
    def n_series(self) -> int:
        return int(self._mu0.size)

    @property
    def n_groups(self) -> int:
        return len(self._groups)

    # -- membership ----------------------------------------------------
    def absorb(self, batch: BatchedBOCD) -> "MultiGroupHandle":
        """Adopt a warmed standalone batch as a new group; returns its
        handle. The batch's posterior state is copied verbatim — its columns
        append to the shared arrays, its rows land in the group's prefix."""
        if not isinstance(batch, BatchedBOCD):
            raise TypeError(f"MultiBOCD absorbs BatchedBOCD, got {type(batch)!r}")
        if self._groups:
            for name in ("kappa0", "alpha0", "beta0", "truncation",
                         "cp_threshold"):
                if getattr(batch, name) != getattr(self, name):
                    raise ValueError(
                        f"group {name}={getattr(batch, name)!r} differs from "
                        f"the shared frontier's {getattr(self, name)!r}"
                    )
        else:
            self.kappa0 = batch.kappa0
            self.alpha0 = batch.alpha0
            self.beta0 = batch.beta0
            self.truncation = batch.truncation
            self.cp_threshold = batch.cp_threshold
            self._kap_lad = np.array([self.kappa0])
            self._alp_lad = np.array([self.alpha0])
            self._const_lad = _gammaln((2.0 * self._alp_lad + 1.0) / 2.0) - \
                _gammaln(2.0 * self._alp_lad / 2.0)
        kb, bb = batch._log_r.shape
        b0 = self.n_series
        k_new = max(self._log_r.shape[0], kb)

        def _pad(a: np.ndarray, fill: float) -> np.ndarray:
            if a.shape[0] == k_new:
                return a
            out = np.full((k_new, a.shape[1]), fill)
            out[: a.shape[0]] = a
            return out

        self._log_r = np.hstack(
            [_pad(self._log_r, -np.inf), _pad(batch._log_r, -np.inf)]
        )
        # Void-cell stats only need to stay finite (their posterior is -inf
        # forever); pad with the prior.
        self._mu = np.hstack([_pad(self._mu, 0.0), _pad(batch._mu, 0.0)])
        self._beta = np.hstack(
            [_pad(self._beta, self.beta0), _pad(batch._beta, self.beta0)]
        )
        self._mu0 = np.concatenate([self._mu0, batch._mu0])
        # Row age = number of +1.0 kappa updates absorbed since the prior:
        # recovered exactly from the batch's kappa row (small-integer float
        # arithmetic — the original prior-seeded row has age == rl, rows
        # born by an update have age == rl + 1, so rl alone is ambiguous).
        ages = np.zeros((k_new, bb), dtype=np.int64)
        ages[:kb] = np.rint(
            batch._kappa_row - self.kappa0
        ).astype(np.int64)[:, None]
        age_pad = self._age
        if age_pad.shape[0] != k_new:
            grown = np.zeros((k_new, age_pad.shape[1]), dtype=np.int64)
            grown[: age_pad.shape[0]] = age_pad
            age_pad = grown
        self._age = np.hstack([age_pad, ages])
        hi = int(ages[:kb].max()) if kb else 0
        self._age_hi = max(self._age_hi, hi)
        self._ensure_ladder(self._age_hi)
        self._log_h = np.concatenate(
            [self._log_h, np.full(bb, math.log(batch.hazard))]
        )
        self._log_1mh = np.concatenate(
            [self._log_1mh, np.full(bb, math.log1p(-batch.hazard))]
        )
        grp = _MultiGroup(
            cols=np.arange(b0, b0 + bb, dtype=np.int64),
            hazard=batch.hazard,
            cap=batch.max_hypotheses,
            k=kb,
            rl=batch._rl.copy(),
            t=batch._t,
        )
        grp.refresh_range()
        self._groups.append(grp)
        return MultiGroupHandle(self, grp)

    def export(self, grp: _MultiGroup) -> BatchedBOCD:
        """Materialize one group back into a standalone batch (bit-equal
        state; used for consolidation rebuilds and equivalence tests)."""
        out = BatchedBOCD(
            grp.cols.size,
            hazard=grp.hazard,
            mu0=self._mu0[grp.cols],
            kappa0=self.kappa0,
            alpha0=self.alpha0,
            beta0=self.beta0,
            cp_threshold=self.cp_threshold,
            truncation=self.truncation,
            max_hypotheses=grp.cap,
        )
        # ascontiguousarray: the shared arrays are C-ordered but wider than
        # the group, and numpy's reduction path (row-sequential vs 1-D
        # pairwise) depends on layout — a standalone batch's arrays are
        # compact C-ordered.
        out._log_r = np.ascontiguousarray(self._log_r[: grp.k, grp.c0:grp.c1])
        out._mu = np.ascontiguousarray(self._mu[: grp.k, grp.c0:grp.c1])
        out._beta = np.ascontiguousarray(self._beta[: grp.k, grp.c0:grp.c1])
        # Row-constant kappa/alpha reconstruct from the age ladders (the
        # ladder is the same +1.0/+0.5 accumulation chain, so the values
        # are bit-identical to an incrementally maintained row).
        ages = self._age[: grp.k, grp.c0]
        out._kappa_row = self._kap_lad[ages]
        out._alpha_row = self._alp_lad[ages]
        out._rl = grp.rl.copy()
        out._t = grp.t
        return out

    def take_group_columns(self, grp: _MultiGroup, idx: np.ndarray) -> None:
        """Per-group :meth:`BatchedBOCD.take_columns`: keep the group's
        local columns ``idx``, drop the rest from the shared arrays, then
        compact the group's rows exactly like the standalone would."""
        idx = np.asarray(idx, dtype=np.int64)
        kept = grp.cols[idx]
        removed = np.setdiff1d(grp.cols, kept)
        if removed.size:
            mask = np.ones(self.n_series, dtype=bool)
            mask[removed] = False
            self._log_r = self._log_r[:, mask]
            self._mu = self._mu[:, mask]
            self._beta = self._beta[:, mask]
            self._age = self._age[:, mask]
            self._mu0 = self._mu0[mask]
            self._log_h = self._log_h[mask]
            self._log_1mh = self._log_1mh[mask]
            remap = np.cumsum(mask) - 1
            for g in self._groups:
                if g is grp:
                    continue
                g.cols = remap[g.cols]
                g.refresh_range()
            grp.cols = remap[kept]
        if grp.cols.size == 0:
            self._groups.remove(grp)
            self._shrink()
            return
        grp.refresh_range()
        sub = self._log_r[: grp.k, grp.c0:grp.c1]
        alive = np.isfinite(sub).any(axis=1)
        if alive.size:
            alive[0] = True
        if not alive.all():
            self._pack_group(grp, np.flatnonzero(alive), grp.k)
        self._shrink()

    def retune_group(
        self,
        grp: _MultiGroup,
        hazard: float | None = None,
        max_hypotheses: int | None = None,
    ) -> None:
        if hazard is not None:
            grp.hazard = hazard
            self._log_h[grp.c0:grp.c1] = math.log(hazard)
            self._log_1mh[grp.c0:grp.c1] = math.log1p(-hazard)
        if max_hypotheses is not None:
            grp.cap = max_hypotheses

    # -- fused tick ----------------------------------------------------
    def update(self, x: np.ndarray) -> None:
        """Feed one observation per stream; advances every group at once."""
        b = self.n_series
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (b,):
            raise ValueError(f"expected shape ({b},), got {x.shape}")
        groups = self._groups
        if not groups:
            return
        k = self._log_r.shape[0]
        # Per-cell kappa/alpha/const via one ladder gather each (ages are
        # row-constant per group on live cells; void cells keep counting but
        # their posterior is -inf, so only finiteness matters there). The
        # (k+1)-tall age array built here doubles as the post-update ages.
        self._age_hi += 1
        self._ensure_ladder(self._age_hi)
        age_all = np.empty((k + 1, b), dtype=np.int64)
        age_all[0] = 0
        age_all[1:] = self._age
        kappa_all = self._kap_lad[age_all]
        kappa = kappa_all[1:]
        alpha = self._alp_lad[self._age]
        const = self._const_lad[self._age]

        # Student-t log-predictive: the exact _student_t_logpdf_rows chain,
        # with the row-constant factors materialized per cell (same floats,
        # same op order -> bit-identical).
        df = 2.0 * alpha
        scale2 = self._beta * (kappa + 1.0)
        scale2 /= alpha * kappa
        z2 = x - self._mu
        np.multiply(z2, z2, out=z2)
        z2 /= scale2
        z2 /= df
        np.log1p(z2, out=z2)
        z2 *= (df + 1.0) / 2.0
        scale2 *= np.pi * df
        np.log(scale2, out=scale2)
        scale2 *= 0.5
        np.subtract(const, scale2, out=scale2)
        scale2 -= z2
        log_growth = scale2
        log_growth += self._log_r
        log_growth += self._log_1mh
        log_cp = _student_t_logpdf(
            x, self._mu0, np.float64(self.kappa0), np.float64(self.alpha0),
            np.float64(self.beta0),
        )
        log_cp = log_cp + self._log_h

        new_log_r = np.empty((k + 1, b))
        new_log_r[0] = log_cp
        new_log_r[1:] = log_growth
        norm = _logsumexp_cols(new_log_r)
        for g in groups:
            # Single-column groups normalize over a contiguous (k+1, 1)
            # array in the standalone batch, which numpy reduces on the 1-D
            # pairwise path — recompute on the per-cohort shape.
            if g.c1 - g.c0 == 1:
                norm[g.c0] = _logsumexp_cols(
                    np.ascontiguousarray(new_log_r[: g.k + 1, g.c0:g.c1])
                )[0]
        new_log_r -= norm

        mu_all = np.empty((k + 1, b))
        mu_all[0] = self._mu0
        mu_all[1:] = self._mu
        beta_all = np.empty((k + 1, b))
        beta_all[0] = self.beta0
        beta_all[1:] = self._beta
        denom = kappa_all + 1.0
        upd = x - mu_all
        np.multiply(upd, upd, out=upd)
        upd *= 0.5 * kappa_all
        upd /= denom
        beta_all += upd
        mu_all *= kappa_all
        mu_all += x
        mu_all /= denom
        age_all += 1
        self._age = age_all
        for g in groups:
            rl = np.empty(g.k + 1, dtype=np.int64)
            rl[0] = 0
            rl[1:] = g.rl
            rl[1:] += 1
            g.rl = rl
            g.k += 1
            g.t += 1
        self._t += 1

        # Per-column truncation (global: void cells are excluded by the
        # isfinite mask) ...
        dead = new_log_r <= math.log(self.truncation)
        dead[0] = False
        dead &= np.isfinite(new_log_r)
        if dead.any():
            new_log_r[dead] = -np.inf
        # ... the shared frontier cap, per group (contiguous column ranges:
        # slices are views, so the kill writes through) ...
        for g in groups:
            cap = g.cap
            k1 = g.k
            if cap is None or k1 <= cap:
                continue
            sub = new_log_r[:k1, g.c0:g.c1]
            strength = np.max(sub, axis=1)
            order = np.argsort(strength[1:], kind="stable")  # ascending
            kill = np.zeros((k1, g.c1 - g.c0), dtype=bool)
            kill[order[: k1 - cap] + 1] = True
            kill &= np.isfinite(sub)
            if kill.any():
                sub[kill] = -np.inf
                dead[:k1, g.c0:g.c1] |= kill
        # ... and one renormalize + compact pass per affected group, on
        # operands shaped exactly like the standalone batch's.
        for g in groups:
            k1 = g.k
            gdead = dead[:k1, g.c0:g.c1]
            if not gdead.any():
                continue
            cols_aff = gdead.any(axis=0)
            # Memory layout decides numpy's reduction path, so each branch
            # mirrors the standalone operand's layout exactly: the >0.5
            # branch renormalizes the full C-ordered posterior, the other
            # renormalizes an F-ordered axis-1 fancy copy.
            if cols_aff.mean() > 0.5:
                operand = np.ascontiguousarray(new_log_r[:k1, g.c0:g.c1])
                gnorm = _logsumexp_cols(operand)
                new_log_r[:k1, g.c0:g.c1] -= gnorm
            else:
                sel = g.cols[cols_aff]
                operand = new_log_r[:k1][:, sel]
                gnorm = _logsumexp_cols(operand)
                new_log_r[np.arange(k1)[:, None], sel[None, :]] -= gnorm
            alive = np.isfinite(new_log_r[:k1, g.c0:g.c1]).any(axis=1)
            alive[0] = True
            if not alive.all():
                self._pack_group(
                    grp=g, rows=np.flatnonzero(alive), k1=k1,
                    log_r=new_log_r, mu=mu_all, beta=beta_all,
                )
        k_max = max(g.k for g in groups)
        self._log_r = new_log_r[:k_max]
        self._mu = mu_all[:k_max]
        self._beta = beta_all[:k_max]
        if self._age.shape[0] > k_max:
            self._age = self._age[:k_max]

    def _pack_group(
        self,
        grp: _MultiGroup,
        rows: np.ndarray,
        k1: int,
        log_r: np.ndarray | None = None,
        mu: np.ndarray | None = None,
        beta: np.ndarray | None = None,
    ) -> None:
        """Compact ``grp``'s live rows to the prefix, voiding the tail."""
        log_r = self._log_r if log_r is None else log_r
        mu = self._mu if mu is None else mu
        beta = self._beta if beta is None else beta
        m = rows.size
        c0, c1 = grp.c0, grp.c1
        for arr in (log_r, mu, beta, self._age):
            arr[:m, c0:c1] = arr[rows, c0:c1]
        log_r[m:k1, c0:c1] = -np.inf
        grp.rl = grp.rl[rows]
        grp.k = m

    def _shrink(self) -> None:
        if not self._groups:
            self._log_r = np.zeros((0, self.n_series))
            self._mu = np.zeros((0, self.n_series))
            self._beta = np.zeros((0, self.n_series))
            self._age = np.zeros((0, self.n_series), dtype=np.int64)
            return
        k_max = max(g.k for g in self._groups)
        if k_max < self._log_r.shape[0]:
            self._log_r = self._log_r[:k_max]
            self._mu = self._mu[:k_max]
            self._beta = self._beta[:k_max]
            self._age = self._age[:k_max]

    # -- per-group detection statistics --------------------------------
    def p_recent_group(self, grp: _MultiGroup, window: int = 2) -> np.ndarray:
        j = int(np.searchsorted(grp.rl, window, side="right"))
        if j == 0:
            return np.zeros(grp.cols.size)
        return np.exp(
            _logsumexp_cols(
                np.ascontiguousarray(self._log_r[:j, grp.c0:grp.c1])
            )
        )

    def map_runlength_group(self, grp: _MultiGroup) -> np.ndarray:
        return grp.rl[
            np.argmax(self._log_r[: grp.k, grp.c0:grp.c1], axis=0)
        ]

    # -- state capture (campaign fork/restore contract) ------------------
    def snapshot(self) -> dict:
        """Full fused-frontier state as private copies. Group order is
        preserved, so a caller holding per-group handles can re-associate
        them by index after :meth:`restore`."""
        return {
            "params": (self.kappa0, self.alpha0, self.beta0,
                       self.truncation, self.cp_threshold),
            "log_r": self._log_r.copy(),
            "mu": self._mu.copy(),
            "beta": self._beta.copy(),
            "mu0": self._mu0.copy(),
            "age": self._age.copy(),
            "age_hi": self._age_hi,
            "t": self._t,
            "groups": [
                {
                    "cols": g.cols.copy(),
                    "hazard": g.hazard,
                    "cap": g.cap,
                    "k": g.k,
                    "rl": g.rl.copy(),
                    "t": g.t,
                }
                for g in self._groups
            ],
        }

    def restore(self, snap: dict) -> None:
        """Reinstate a :meth:`snapshot` bit-exactly. The age ladders are
        pure functions of the priors and only ever extend, so the current
        (possibly longer) ladders are kept. Existing group objects are
        replaced — callers must rebind handles via ``_groups`` order."""
        (self.kappa0, self.alpha0, self.beta0,
         self.truncation, self.cp_threshold) = snap["params"]
        self._log_r = snap["log_r"].copy()
        self._mu = snap["mu"].copy()
        self._beta = snap["beta"].copy()
        self._mu0 = snap["mu0"].copy()
        self._age = snap["age"].copy()
        self._age_hi = snap["age_hi"]
        if (self._kap_lad[0] != self.kappa0
                or self._alp_lad[0] != self.alpha0):
            self._kap_lad = np.array([self.kappa0])
            self._alp_lad = np.array([self.alpha0])
            self._const_lad = _gammaln((2.0 * self._alp_lad + 1.0) / 2.0) - \
                _gammaln(2.0 * self._alp_lad / 2.0)
        self._ensure_ladder(self._age_hi)
        self._t = snap["t"]
        self._groups = []
        for g in snap["groups"]:
            grp = _MultiGroup(
                cols=g["cols"].copy(), hazard=g["hazard"], cap=g["cap"],
                k=g["k"], rl=g["rl"].copy(), t=g["t"],
            )
            grp.refresh_range()
            self._groups.append(grp)
        b = self.n_series
        self._log_h = np.empty(b)
        self._log_1mh = np.empty(b)
        for grp in self._groups:
            self._log_h[grp.c0:grp.c1] = math.log(grp.hazard)
            self._log_1mh[grp.c0:grp.c1] = math.log1p(-grp.hazard)


class MultiGroupHandle:
    """Per-cohort :class:`ScreeningBackend` facade over one
    :class:`MultiBOCD` group — everything except ``update`` (observations
    flow through the owner's fused :meth:`MultiBOCD.update`)."""

    def __init__(self, multi: MultiBOCD, grp: _MultiGroup) -> None:
        self.multi = multi
        self.group = grp

    @property
    def n_series(self) -> int:
        return int(self.group.cols.size)

    @property
    def cols(self) -> np.ndarray:
        """This group's column indices into the fused input vector."""
        return self.group.cols

    @property
    def hazard(self) -> float:
        return self.group.hazard

    @property
    def max_hypotheses(self) -> int | None:
        return self.group.cap

    def update(self, x: np.ndarray) -> np.ndarray:
        raise RuntimeError(
            "MultiGroupHandle does not update per group; feed the fused "
            "MultiBOCD.update once per tick"
        )

    def p_recent_change(self, window: int = 2) -> np.ndarray:
        return self.multi.p_recent_group(self.group, window)

    def map_runlength(self) -> np.ndarray:
        return self.multi.map_runlength_group(self.group)

    def take_columns(self, idx: np.ndarray) -> None:
        self.multi.take_group_columns(self.group, idx)

    def retune(
        self,
        hazard: float | None = None,
        max_hypotheses: int | None = None,
    ) -> None:
        self.multi.retune_group(
            self.group, hazard=hazard, max_hypotheses=max_hypotheses
        )

    def export(self) -> BatchedBOCD:
        return self.multi.export(self.group)


def noise_scale(series: np.ndarray) -> float:
    """Robust per-step noise estimate: MAD of first differences.

    First differences cancel slow level drift, so this measures *jitter*;
    BOCD observations are standardized by it, making the detector sensitive
    to any statistically significant level shift regardless of its relative
    size (the 10 % relevance filter is the separate verification step).
    """
    x = np.asarray(series, dtype=np.float64)
    if x.size < 3:
        return max(float(np.median(np.abs(x))) * 1e-2, 1e-9)
    d = np.diff(x)
    mad = float(np.median(np.abs(d - np.median(d))))
    sigma = 1.4826 * mad / np.sqrt(2.0)
    floor = max(float(np.median(np.abs(x))) * 1e-3, 1e-9)
    return max(sigma, floor)


def noise_scale_batch(series: np.ndarray) -> np.ndarray:
    """Column-wise :func:`noise_scale` over a ``(T, B)`` matrix, shape (B,)."""
    x = np.asarray(series, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError("expected a (T, B) matrix")
    absmed = np.median(np.abs(x), axis=0)
    if x.shape[0] < 3:
        return np.maximum(absmed * 1e-2, 1e-9)
    d = np.diff(x, axis=0)
    mad = np.median(np.abs(d - np.median(d, axis=0)), axis=0)
    sigma = 1.4826 * mad / np.sqrt(2.0)
    floor = np.maximum(absmed * 1e-3, 1e-9)
    return np.maximum(sigma, floor)


def detect_change_points(
    series: np.ndarray,
    hazard: float = 1.0 / 100.0,
    cp_threshold: float = DEFAULT_CP_THRESHOLD,
    min_gap: int = 3,
    recent_window: int = 2,
) -> list[int]:
    """Run BOCD over ``series``; return change-point indices.

    A change is reported at index ``i - map_runlength`` whenever the
    posterior probability of a change within the last ``recent_window``
    observations exceeds ``cp_threshold`` (paper: likelihood of r_t = 0
    above 0.9 — evaluated over a tiny window so the single-step hazard
    factor does not suppress genuine onsets). ``min_gap`` merges the burst
    of detections that one physical change produces.
    """
    x = np.asarray(series, dtype=np.float64)
    if x.size == 0:
        return []
    scale = noise_scale(x)
    det = BOCD(
        hazard=hazard,
        mu0=float(x[0] / scale),
        kappa0=1.0,
        alpha0=1.0,
        beta0=1.0,
        cp_threshold=cp_threshold,
    )
    out: list[int] = []
    for i, xi in enumerate(x):
        det.update(float(xi / scale))
        if i <= recent_window:  # p_recent is trivially 1 in the first steps
            continue
        if det.p_recent_change(recent_window) > cp_threshold:
            idx = i - det.map_runlength()
            if idx > 0 and (not out or idx - out[-1] >= min_gap):
                out.append(idx)
    return out


def detect_change_points_batch(
    series: np.ndarray,
    hazard: float = 1.0 / 100.0,
    cp_threshold: float = DEFAULT_CP_THRESHOLD,
    min_gap: int = 3,
    recent_window: int = 2,
) -> list[list[int]]:
    """Batched :func:`detect_change_points` over a ``(T, B)`` matrix.

    Returns one change-point index list per column, matching what the scalar
    routine reports on that column alone.
    """
    x = np.asarray(series, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError("expected a (T, B) matrix")
    t_steps, b = x.shape
    out: list[list[int]] = [[] for _ in range(b)]
    if t_steps == 0 or b == 0:
        return out
    scale = noise_scale_batch(x)
    det = BatchedBOCD(
        b, hazard=hazard, mu0=x[0] / scale, cp_threshold=cp_threshold
    )
    xs = x / scale
    for i in range(t_steps):
        det.update(xs[i])
        if i <= recent_window:
            continue
        flagged = np.flatnonzero(det.p_recent_change(recent_window) > cp_threshold)
        if flagged.size == 0:
            continue
        run_lengths = det.map_runlength()
        for col in flagged:
            idx = i - int(run_lengths[col])
            dst = out[col]
            if idx > 0 and (not dst or idx - dst[-1] >= min_gap):
                dst.append(idx)
    return out


def _student_t_logpdf(
    x: float | np.ndarray,
    mu: np.ndarray,
    kappa: np.ndarray,
    alpha: np.ndarray,
    beta: np.ndarray,
) -> np.ndarray:
    """Posterior-predictive Student-t of the Normal-Gamma model.

    Broadcasts over any leading hypothesis/batch axes: scalar ``x`` against
    1-D stats (scalar BOCD) or ``(B,)`` observations against ``(K, B)``
    stats (batched BOCD).
    """
    df = 2.0 * alpha
    scale2 = beta * (kappa + 1.0) / (alpha * kappa)
    z2 = (x - mu) ** 2 / scale2
    return (
        _gammaln((df + 1.0) / 2.0)
        - _gammaln(df / 2.0)
        - 0.5 * np.log(np.pi * df * scale2)
        - (df + 1.0) / 2.0 * np.log1p(z2 / df)
    )


def _student_t_logpdf_rows(
    x: np.ndarray,
    mu: np.ndarray,
    kappa_row: np.ndarray,
    alpha_row: np.ndarray,
    beta: np.ndarray,
) -> np.ndarray:
    """:func:`_student_t_logpdf` with row-constant kappa/alpha ``(K,)``
    against ``(K, B)`` mu/beta — the gammaln terms collapse to O(K). Applies
    the exact same per-element operation chain, so results are bit-identical
    to the generic version."""
    df = 2.0 * alpha_row
    const = _gammaln((df + 1.0) / 2.0) - _gammaln(df / 2.0)
    scale2 = beta * (kappa_row + 1.0)[:, None]
    scale2 /= (alpha_row * kappa_row)[:, None]
    z2 = x - mu
    np.multiply(z2, z2, out=z2)
    z2 /= scale2
    z2 /= df[:, None]
    np.log1p(z2, out=z2)
    z2 *= ((df + 1.0) / 2.0)[:, None]
    scale2 *= (np.pi * df)[:, None]
    np.log(scale2, out=scale2)
    scale2 *= 0.5
    np.subtract(const[:, None], scale2, out=scale2)
    scale2 -= z2
    return scale2


def _logsumexp(a: np.ndarray) -> float:
    m = float(np.max(a))
    if math.isinf(m):
        return m
    return m + math.log(float(np.sum(np.exp(a - m))))


def _logsumexp_cols(a: np.ndarray) -> np.ndarray:
    """Column-wise logsumexp of a (K, B) matrix; all ``-inf`` columns -> -inf."""
    m = np.max(a, axis=0)
    shift = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return np.log(np.sum(np.exp(a - shift), axis=0)) + shift


try:  # scipy is available in this environment; keep a pure fallback anyway.
    from scipy.special import gammaln as _gammaln
except ImportError:  # pragma: no cover
    def _gammaln(x):
        return np.vectorize(math.lgamma)(x)


# ----------------------------------------------------------------------
# Screening backends (docs/kernels.md)
#
# The fleet screening loop talks to an *instance* implementing the batched
# interface below; FleetDetect / ControlPlane select a backend *factory*
# (scalar / batched-numpy / torch / cuda) instead of hard-wiring BatchedBOCD, so
# implementations stay interchangeable and equivalence-tested from one
# registry.
# ----------------------------------------------------------------------

@runtime_checkable
class ScreeningBackend(Protocol):
    """Batched run-length screening state over ``n_series`` streams.

    The contract (shapes per :class:`BatchedBOCD`, the reference semantics):
    ``update(x)`` consumes one observation per stream and returns
    ``Pr(r_t = 0)`` per stream; ``p_recent_change``/``map_runlength`` report
    posterior statistics; ``take_columns`` sub-slices streams on membership
    churn; ``retune`` adjusts hazard / frontier cap for future updates.
    """

    n_series: int

    def update(self, x: np.ndarray) -> np.ndarray: ...
    def p_recent_change(self, window: int = 2) -> np.ndarray: ...
    def map_runlength(self) -> np.ndarray: ...
    def take_columns(self, idx: np.ndarray) -> None: ...
    def retune(self, hazard: float | None = None,
               max_hypotheses: int | None = None) -> None: ...


class ScalarFanout:
    """B independent scalar :class:`BOCD` detectors behind the batched
    screening interface — the per-column oracle as "just another backend".

    O(B) Python-loop cost per tick; useful for tiny fleets and as the
    ground truth the vectorized/torch/cuda backends are equivalence-tested
    against (per column it *is* the scalar recursion, bit for bit).
    """

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
        max_hypotheses: int | None = None,
    ) -> None:
        b = int(n_series)
        mu0 = np.broadcast_to(np.asarray(mu0, dtype=np.float64), (b,))
        self.n_series = b
        self.hazard = hazard
        self.cp_threshold = cp_threshold
        self.max_hypotheses = max_hypotheses
        self._dets = [
            BOCD(
                hazard=hazard, mu0=float(m), kappa0=kappa0, alpha0=alpha0,
                beta0=beta0, cp_threshold=cp_threshold, truncation=truncation,
                max_hypotheses=max_hypotheses,
            )
            for m in mu0
        ]

    def update(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (self.n_series,):
            raise ValueError(f"expected shape ({self.n_series},), got {x.shape}")
        return np.fromiter(
            (d.update(float(xi)) for d, xi in zip(self._dets, x)),
            dtype=np.float64, count=self.n_series,
        )

    def p_recent_change(self, window: int = 2) -> np.ndarray:
        return np.fromiter(
            (d.p_recent_change(window) for d in self._dets),
            dtype=np.float64, count=self.n_series,
        )

    def map_runlength(self) -> np.ndarray:
        return np.fromiter(
            (d.map_runlength() for d in self._dets),
            dtype=np.int64, count=self.n_series,
        )

    def take_columns(self, idx: np.ndarray) -> None:
        idx = np.asarray(idx, dtype=np.int64)
        self._dets = [self._dets[int(i)] for i in idx]
        self.n_series = int(idx.size)

    def retune(
        self,
        hazard: float | None = None,
        max_hypotheses: int | None = None,
    ) -> None:
        if hazard is not None:
            self.hazard = hazard
        if max_hypotheses is not None:
            self.max_hypotheses = max_hypotheses
        for d in self._dets:
            d.retune(hazard=hazard, max_hypotheses=max_hypotheses)


class ScreeningBackendFactory:
    """Constructs :class:`ScreeningBackend` instances.

    The screening layer creates backend state dynamically (one instance per
    warmed cohort, sized to the cohort and seeded with its per-stream
    ``mu0``), so the pluggable unit is a *factory*, not an instance.
    """

    name = "abstract"

    def make(self, n_series: int, **kwargs) -> ScreeningBackend:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<ScreeningBackendFactory {self.name!r}>"


class ScalarScreening(ScreeningBackendFactory):
    name = "scalar"

    def make(self, n_series: int, **kwargs) -> ScalarFanout:
        return ScalarFanout(n_series, **kwargs)


class BatchedScreening(ScreeningBackendFactory):
    name = "batched"

    def make(self, n_series: int, **kwargs) -> BatchedBOCD:
        return BatchedBOCD(n_series, **kwargs)


class TorchScreening(ScreeningBackendFactory):
    """The plain PyTorch fixed-slot step
    (:class:`repro_torch.kernels.bocd_step.TorchBOCD`) on ``device`` (None =
    the card). ``dtype`` defaults to float64: the tight-parity path."""

    name = "torch"
    _backend = "TorchBOCD"

    def __init__(self, device=None, dtype=None) -> None:
        self.device = device
        self.dtype = dtype

    def make(self, n_series: int, **kwargs):
        from repro_torch.kernels import bocd_step

        kwargs.setdefault("device", self.device)
        if self.dtype is not None:
            kwargs.setdefault("dtype", self.dtype)
        return getattr(bocd_step, self._backend)(n_series, **kwargs)


class CudaScreening(TorchScreening):
    """The hand-written CUDA step kernel
    (:class:`repro_torch.kernels.bocd_step.CudaBOCD`); ``dtype`` defaults
    to float32, the accelerator's width (the fleet screen still raises the
    float64 ``batched`` backend's flags — see PERF.md)."""

    name = "cuda"
    _backend = "CudaBOCD"


#: Registry enumerated by the backend-equivalence tests; ``numpy`` is an
#: alias for the vectorized numpy implementation. ``torch`` is the kernel's
#: plain PyTorch version, ``cuda`` the kernel itself.
SCREENING_BACKENDS: dict[str, ScreeningBackendFactory] = {
    "scalar": ScalarScreening(),
    "batched": BatchedScreening(),
    "torch": TorchScreening(),
    "cuda": CudaScreening(),
}
SCREENING_BACKENDS["numpy"] = SCREENING_BACKENDS["batched"]


def select_backend(
    name: str | None = None, device=None
) -> ScreeningBackendFactory:
    """Resolve a screening backend by name.

    ``None``/``"auto"`` picks the CUDA kernel on the card and raises when
    there is none — unless ``device`` names the CPU, where it picks the plain
    ``torch`` step. ``device`` binds the ``torch``/``cuda`` factories; the
    numpy backends (``scalar``, ``batched``/``numpy``) ignore it.
    """
    if name is None or name == "auto":
        from repro_torch.device import resolve_device

        name = "cuda" if resolve_device(device).type == "cuda" else "torch"
    try:
        factory = SCREENING_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown screening backend {name!r}; "
            f"registered: {sorted(SCREENING_BACKENDS)}"
        ) from None
    if device is not None and isinstance(factory, TorchScreening):
        factory = type(factory)(device=device, dtype=factory.dtype)
    return factory


class _ClassShim(ScreeningBackendFactory):
    """Deprecation shim: wraps a backend *class* passed where a factory
    instance is now expected (the pre-backend-API constructor style)."""

    def __init__(self, cls: type) -> None:
        self._cls = cls
        self.name = getattr(cls, "__name__", "class")

    def make(self, n_series: int, **kwargs) -> ScreeningBackend:
        return self._cls(n_series, **kwargs)


def resolve_screening_backend(spec, device=None) -> ScreeningBackendFactory:
    """Accept a backend name, ``None``/``"auto"``, a factory instance, or
    (deprecated, with a warning) a backend class such as ``BatchedBOCD``.
    ``device`` is forwarded to :func:`select_backend` for names."""
    if spec is None or isinstance(spec, str):
        return select_backend(spec, device=device)
    if isinstance(spec, type):
        warnings.warn(
            "passing a screening backend class is deprecated; pass a "
            "ScreeningBackendFactory instance or a registry name "
            f"(e.g. {sorted(set(SCREENING_BACKENDS))!r})",
            DeprecationWarning,
            stacklevel=2,
        )
        if spec is BatchedBOCD:
            return SCREENING_BACKENDS["batched"]
        if spec is BOCD:
            return SCREENING_BACKENDS["scalar"]
        return _ClassShim(spec)
    if isinstance(spec, ScreeningBackendFactory) or hasattr(spec, "make"):
        return spec
    raise TypeError(
        f"screening backend must be a name, factory, or class; got {spec!r}"
    )
