"""Direct-exposure score (paper §4, Eq. 4).

Replace stage s with a clipped baseline and recompute the frontier:

    b[t,r,s]  = min(d[t,r,s], b_tilde[t,r,s])      (never exceeds observation)
    G_s(b)    = sum_t (F[t,S] - F^{s<-b}[t,S]) / sum_t F[t,S]   >= 0

For a feasible baseline whose stage-s reduction also removes the downstream
wait it induces, G_s lower-bounds the model-scoped gain; otherwise it is a
conservative sensitivity score, not an intervention estimate — the
recomputation leaves any non-removable downstream wait in place.

Baselines provided: per-rank window median, cohort (cross-rank) median, and
an explicit no-stall reference.
"""
from __future__ import annotations

import numpy as np

from .frontier import _check

__all__ = [
    "clipped_matrix",
    "direct_exposure_gain",
    "all_stage_gains",
    "per_rank_median_baseline",
    "cohort_median_baseline",
]


def per_rank_median_baseline(durations: np.ndarray) -> np.ndarray:
    """b_tilde[t,r,s] = median over the window of rank r's stage-s durations."""
    d = _check(durations)
    med = np.median(d, axis=0, keepdims=True)          # [1, R, S]
    return np.broadcast_to(med, d.shape).copy()


def cohort_median_baseline(durations: np.ndarray) -> np.ndarray:
    """b_tilde[t,r,s] = median over (window x ranks) — a cross-rank reference.

    Robust when one rank is persistently slow (its own median is inflated,
    so the per-rank baseline would hide a constant straggler).
    """
    d = _check(durations)
    med = np.median(d, axis=(0, 1), keepdims=True)     # [1, 1, S]
    return np.broadcast_to(med, d.shape).copy()


def clipped_matrix(
    durations: np.ndarray, baseline: np.ndarray, stage: int
) -> np.ndarray:
    """Return a copy of d with stage `stage` replaced by min(d, baseline)."""
    d = _check(durations).copy()
    b = np.asarray(baseline, dtype=np.float64)
    if b.shape != d.shape:
        b = np.broadcast_to(b, d.shape)
    d[:, :, stage] = np.minimum(d[:, :, stage], b[:, :, stage])
    return d


def direct_exposure_gain(
    durations: np.ndarray, baseline: np.ndarray, stage: int
) -> float:
    """G_s (Eq. 4) for one stage; >= 0 by the clipping."""
    d = _check(durations)
    exposed = np.cumsum(d, axis=2).max(axis=1)[:, -1]
    denom = float(exposed.sum())
    if denom <= 0.0:
        return 0.0
    repl = clipped_matrix(d, baseline, stage)
    exposed_repl = np.cumsum(repl, axis=2).max(axis=1)[:, -1]
    return float((exposed - exposed_repl).sum()) / denom


def all_stage_gains(
    durations: np.ndarray, baseline: np.ndarray | None = None
) -> np.ndarray:
    """G_s for every stage. [S]

    Default baseline is the per-rank window median.  This is the (S+1)-pass
    computation the Pallas kernel fuses into one HBM read.
    """
    d = _check(durations)
    if baseline is None:
        baseline = per_rank_median_baseline(d)
    return np.array(
        [direct_exposure_gain(d, baseline, s) for s in range(d.shape[2])]
    )
