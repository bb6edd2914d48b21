"""Routing candidate sets (paper §4).

The routing candidate set C_route is the smallest leading-share prefix whose
cumulative share reaches tau_C (default 0.80).  The evaluation reports
top-2 (seeded stage among the two highest shares) and candidate hit
(anywhere in the prefix), always paired with candidate-set size.  The
routing set is kept separate from the ambiguity set (co_critical).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RoutingSet", "candidate_set", "score_routing"]


@dataclasses.dataclass(frozen=True)
class RoutingSet:
    """Ordered routing candidates (stage indices, descending score)."""

    stages: tuple[int, ...]
    scores: tuple[float, ...]        # full score vector, not just candidates
    tau: float

    @property
    def size(self) -> int:
        return len(self.stages)

    @property
    def top1(self) -> int:
        return self.stages[0]

    def topk(self, k: int) -> tuple[int, ...]:
        # descending score, LOWEST index first on ties — the same tie
        # convention as every other routing surface (frontier leaders,
        # fleet route entries); reversing a stable ascending sort would
        # silently prefer the highest tied index instead.
        order = tuple(
            int(i) for i in np.argsort(-np.asarray(self.scores), kind="stable")
        )
        return order[:k]

    def hit(self, stage: int) -> bool:
        return stage in self.stages

    def top2_hit(self, stage: int) -> bool:
        return stage in self.topk(2)

    def top1_hit(self, stage: int) -> bool:
        return stage == self.top1


def candidate_set(scores: np.ndarray, tau: float = 0.80) -> RoutingSet:
    """Smallest descending-score prefix whose cumulative share reaches tau.

    Scores are normalized internally; an all-zero vector yields an empty set.
    """
    v = np.asarray(scores, dtype=np.float64)
    tot = float(v.sum())
    if tot <= 0:
        return RoutingSet(stages=(), scores=tuple(v), tau=tau)
    p = v / tot
    # descending score, lowest stage index first on ties (see topk)
    order = np.argsort(-p, kind="stable")
    cum = 0.0
    chosen: list[int] = []
    for idx in order:
        chosen.append(int(idx))
        cum += float(p[idx])
        if cum >= tau - 1e-12:
            break
    return RoutingSet(stages=tuple(chosen), scores=tuple(v), tau=tau)


def score_routing(
    scores: np.ndarray, seeded_stage: int, tau: float = 0.80
) -> dict:
    """One evaluation row: top-1 / top-2 / candidate-hit flags + set size."""
    rs = candidate_set(scores, tau)
    return {
        "top1": rs.size > 0 and rs.top1_hit(seeded_stage),
        "top2": rs.size > 0 and rs.top2_hit(seeded_stage),
        "candidate_hit": rs.hit(seeded_stage),
        "candidate_size": rs.size,
        "candidates": rs.stages,
    }
