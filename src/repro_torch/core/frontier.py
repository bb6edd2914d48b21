"""Frontier accounting (paper §3).

For step t, rank r, ordered stage s with measured duration d[t,r,s] >= 0:

    P[t,r,s] = sum_{j<=s} d[t,r,j]          rank-local prefix
    F[t,s]   = max_r P[t,r,s]               max-prefix frontier
    a[t,s]   = F[t,s] - F[t,s-1] >= 0       frontier advance

Theorem 1 (telescoping): sum_s a[t,s] = F[t,S]  — an exact, additive
accounting of the step's exposed makespan.

Slack identity: with lambda[t,r,s] = F[t,s-1] - P[t,r,s-1] >= 0,
    a[t,s] = max_r ( d[t,r,s] - lambda[t,r,s] ),
so a rank that arrived early at s-1 has its stage-s duration discounted by
exactly the slack it owes the group — a slow data step that forces others to
wait is charged once, to the data boundary, never again to their waits.

Window share (Eq. 2), step-time weighted:
    A_s = sum_t a[t,s] / sum_t F[t,S].

Everything here is pure NumPy over [N, R, S] (or [R, S]) arrays; the Pallas
kernel in repro.kernels.frontier accelerates the identical computation and is
checked against this module.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "FrontierResult",
    "frontier_accounting",
    "frontier_advances",
    "window_shares",
    "slack",
    "advances_via_slack",
    "per_stage_max_total",
    "per_stage_average_total",
]


@dataclasses.dataclass(frozen=True)
class FrontierResult:
    """Full accounting output for a window matrix d[N, R, S]."""

    prefix: np.ndarray        # P  [N, R, S]
    frontier: np.ndarray      # F  [N, S]
    advances: np.ndarray      # a  [N, S]
    exposed_makespan: np.ndarray  # F[:, -1]  [N]
    #: rank attaining the frontier at each boundary (lowest index on ties).
    leader: np.ndarray        # [N, S] int
    #: per-boundary tie set size at tolerance eta_abs (see leaders_with_ties).
    #: max_r P - second max_r P, +inf when R == 1.
    gap: np.ndarray           # [N, S]
    #: lag L[t,s] = max_r P - median_r P  (paper §4 localization evidence).
    lag: np.ndarray           # [N, S]

    @property
    def num_steps(self) -> int:
        return self.frontier.shape[0]

    @property
    def num_stages(self) -> int:
        return self.frontier.shape[1]

    def shares(self) -> np.ndarray:
        """Step-time-weighted window stage shares A_s (Eq. 2). [S]"""
        return window_shares(self.advances, self.exposed_makespan)

    def delta_lag(self) -> np.ndarray:
        """Increment of the lag across boundaries. [N, S]"""
        return np.diff(
            np.concatenate([np.zeros_like(self.lag[:, :1]), self.lag], axis=1),
            axis=1,
        )


def _check(d: np.ndarray) -> np.ndarray:
    d = np.asarray(d, dtype=np.float64)
    if d.ndim == 2:
        d = d[None]
    if d.ndim != 3:
        raise ValueError(f"expected [N,R,S] or [R,S], got shape {d.shape}")
    if not np.all(np.isfinite(d)) or np.any(d < 0):
        raise ValueError("durations must be finite and nonnegative")
    return d


def frontier_accounting(durations: np.ndarray) -> FrontierResult:
    """Compute the complete frontier decomposition of d[N, R, S].

    Streams in O(R*S) memory per step when called step-at-a-time; this
    vectorized form is O(N*R*S) work either way (the paper's single pass).
    """
    d = _check(durations)
    prefix = np.cumsum(d, axis=2)                      # P[t,r,s]
    frontier = prefix.max(axis=1)                      # F[t,s]
    leader = prefix.argmax(axis=1)                     # first max index
    f_prev = np.concatenate(
        [np.zeros_like(frontier[:, :1]), frontier[:, :-1]], axis=1
    )
    advances = frontier - f_prev                       # a[t,s]
    n, r, s = prefix.shape
    if r >= 2:
        top2 = np.partition(prefix, r - 2, axis=1)[:, r - 2, :]
        gap = frontier - top2
    else:
        gap = np.full((n, s), np.inf)
    lag = frontier - np.median(prefix, axis=1)
    return FrontierResult(
        prefix=prefix,
        frontier=frontier,
        advances=advances,
        exposed_makespan=frontier[:, -1],
        leader=leader,
        gap=gap,
        lag=lag,
    )


def frontier_advances(durations: np.ndarray) -> np.ndarray:
    """Just a[t,s] — the additive exposed-makespan decomposition. [N, S]"""
    return frontier_accounting(durations).advances


def window_shares(advances: np.ndarray, exposed: np.ndarray) -> np.ndarray:
    """A_s = sum_t a[t,s] / sum_t F[t,S]  (Eq. 2).

    Callers below the window-denominator floor should report raw advances
    instead (handled by the labeler / window manager, not here).
    """
    denom = float(np.sum(exposed))
    if denom <= 0.0:
        return np.zeros(advances.shape[-1])
    return np.sum(advances, axis=0) / denom


def slack(durations: np.ndarray) -> np.ndarray:
    """lambda[t,r,s] = F[t,s-1] - P[t,r,s-1] >= 0 (slack owed at boundary s)."""
    d = _check(durations)
    prefix = np.cumsum(d, axis=2)
    frontier = prefix.max(axis=1)
    p_prev = np.concatenate(
        [np.zeros_like(prefix[:, :, :1]), prefix[:, :, :-1]], axis=2
    )
    f_prev = np.concatenate(
        [np.zeros_like(frontier[:, :1]), frontier[:, :-1]], axis=1
    )
    return f_prev[:, None, :] - p_prev


def advances_via_slack(durations: np.ndarray) -> np.ndarray:
    """a[t,s] = max_r (d[t,r,s] - lambda[t,r,s])  — Eq. 3, for validation."""
    d = _check(durations)
    lam = slack(d)
    return np.max(d - lam, axis=1)


# ---------------------------------------------------------------------------
# Comparison summaries (Propositions 1-2 reference quantities)
# ---------------------------------------------------------------------------


def per_stage_max_total(durations: np.ndarray) -> np.ndarray:
    """M_t = sum_s max_r d[t,r,s].  Overcounts F[t,S] by up to min(R,S)."""
    d = _check(durations)
    return d.max(axis=1).sum(axis=-1)


def per_stage_average_total(durations: np.ndarray) -> np.ndarray:
    """Mbar_t = sum_s mean_r d[t,r,s].  Undercounts F[t,S] by up to R."""
    d = _check(durations)
    return d.mean(axis=1).sum(axis=-1)
