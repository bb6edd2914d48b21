"""Comparison stage-attribution rules (paper §6.2).

Each baseline applies one scoring rule to the same [N, R, S] window matrix
used by StageFrontier, sharing windowing, schema validation and tie
tolerance, so routing-matrix counts isolate the scoring rule:

  - per-stage max:        rank stages by max_r share,
  - per-stage average:    rank stages by mean_r share,
  - raw rank spread:      sum_t (max_r d - median_r d), a dispersion
                          heuristic with no stage-attribution semantics,
  - slowest-rank breakdown: stage profile of the per-step slowest rank,
  - rank-0 local total:   ignores all other ranks.

Every rule returns a nonnegative per-stage score vector normalized to sum 1
(when possible), comparable with frontier shares for candidate routing.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .frontier import _check

__all__ = ["BASELINE_RULES", "stage_scores"]


def _normalize(v: np.ndarray) -> np.ndarray:
    tot = float(v.sum())
    return v / tot if tot > 0 else np.zeros_like(v)


def per_stage_max(d: np.ndarray) -> np.ndarray:
    return _normalize(d.max(axis=1).sum(axis=0))


def per_stage_average(d: np.ndarray) -> np.ndarray:
    return _normalize(d.mean(axis=1).sum(axis=0))


def raw_rank_spread(d: np.ndarray) -> np.ndarray:
    spread = d.max(axis=1) - np.median(d, axis=1)      # [N, S]
    return _normalize(spread.sum(axis=0))


def slowest_rank_breakdown(d: np.ndarray) -> np.ndarray:
    slowest = d.sum(axis=2).argmax(axis=1)             # [N]
    rows = d[np.arange(d.shape[0]), slowest, :]        # [N, S]
    return _normalize(rows.sum(axis=0))


def rank0_local_total(d: np.ndarray) -> np.ndarray:
    return _normalize(d[:, 0, :].sum(axis=0))


def frontier_shares(d: np.ndarray) -> np.ndarray:
    prefix = np.cumsum(d, axis=2)
    frontier = prefix.max(axis=1)
    f_prev = np.concatenate(
        [np.zeros_like(frontier[:, :1]), frontier[:, :-1]], axis=1
    )
    return _normalize((frontier - f_prev).sum(axis=0))


BASELINE_RULES: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "stagefrontier": frontier_shares,
    "per_stage_max": per_stage_max,
    "per_stage_average": per_stage_average,
    "raw_rank_spread": raw_rank_spread,
    "slowest_rank_breakdown": slowest_rank_breakdown,
    "rank0_local_total": rank0_local_total,
}


def stage_scores(durations: np.ndarray, method: str) -> np.ndarray:
    """Per-stage score vector (sums to 1) for the named rule."""
    d = _check(durations)
    try:
        rule = BASELINE_RULES[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; choose from {sorted(BASELINE_RULES)}"
        ) from None
    return rule(d)
