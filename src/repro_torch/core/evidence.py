"""Localization evidence (paper §4).

For each boundary the labeler reports:
  - the latest-rank tie set (ranks within eta of the frontier),
  - the lag L[t,s] = max_r P[t,r,s] - median_r P[t,r,s] and its increment,
  - the max-minus-secondmax gap,
  - leader switches, counting only switches between *confident unique*
    leaders (gap above gamma_elig, no tie).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .frontier import FrontierResult

__all__ = ["LeaderEvidence", "leader_evidence", "tie_sets"]


@dataclasses.dataclass(frozen=True)
class LeaderEvidence:
    """Window-level leader/straggler evidence at the final boundary."""

    #: modal frontier-leader rank at the exposed-makespan boundary.
    leader_rank: int
    #: fraction of steps led by that rank (confident unique leads only).
    leader_share: float
    #: switches between confident unique leaders across the window.
    switches: int
    #: steps with a confident unique leader / total steps.
    eligible_share: float
    #: mean final-boundary lag (max - median prefix).
    mean_lag: float
    #: mean final-boundary gap (max - secondmax prefix).
    mean_gap: float
    #: per-step tie-set sizes at the final boundary.
    tie_sizes: tuple[int, ...]


def tie_sets(
    prefix: np.ndarray, stage: int, eta_abs: float
) -> list[np.ndarray]:
    """Ranks within eta_abs of the frontier at `stage`, per step."""
    p = prefix[:, :, stage]                      # [N, R]
    f = p.max(axis=1, keepdims=True)
    return [np.nonzero(p[t] >= f[t] - eta_abs)[0] for t in range(p.shape[0])]


def leader_evidence(
    result: FrontierResult,
    *,
    stage: int | None = None,
    eta_q: float = 0.05,
    gamma_elig: float = 0.02,
) -> LeaderEvidence:
    """Leader/straggler evidence at a boundary (default: exposed makespan).

    The labeler evaluates this at the *top routed stage's* boundary: after a
    group sync, every rank's prefix is rebased to the frontier, so the final
    boundary is structurally tied and the straggler identity lives at the
    boundary where the delay first became exposed.

    eta_q:      tie tolerance as a fraction of the step's exposed makespan.
    gamma_elig: minimum (gap / exposed) for a step to count as a confident
                unique lead; switches are counted only between such steps.
    """
    last = result.num_stages - 1 if stage is None else stage
    p = result.prefix[:, :, last]                # [N, R]
    n, r = p.shape
    exposed = np.maximum(result.exposed_makespan, 1e-30)
    eta_abs = eta_q * exposed                    # [N]
    ties = [np.nonzero(p[t] >= p[t].max() - eta_abs[t])[0] for t in range(n)]
    tie_sizes = tuple(len(t) for t in ties)

    if r >= 2:
        gap = result.gap[:, last]
    else:
        gap = np.full(n, np.inf)
    confident = (gap / exposed >= gamma_elig) & (np.array(tie_sizes) == 1)
    leaders = result.leader[:, last]

    conf_leaders = leaders[confident]
    if conf_leaders.size:
        vals, counts = np.unique(conf_leaders, return_counts=True)
        leader_rank = int(vals[counts.argmax()])
        leader_share = float(counts.max()) / n
        switches = int(np.count_nonzero(np.diff(conf_leaders) != 0))
    else:
        leader_rank = -1
        leader_share = 0.0
        switches = 0

    return LeaderEvidence(
        leader_rank=leader_rank,
        leader_share=leader_share,
        switches=switches,
        eligible_share=float(confident.mean()) if n else 0.0,
        mean_lag=float(result.lag[:, last].mean()) if n else 0.0,
        mean_gap=float(np.where(np.isfinite(gap), gap, 0.0).mean()) if n else 0.0,
        tie_sizes=tie_sizes,
    )
