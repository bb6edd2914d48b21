"""Operational policy driven by StageFrontier labels (beyond-paper layer).

The paper stops at "route the operator / heavy profiler to (window, stage,
rank)".  Because this framework owns the training loop, the label stream
drives concrete actions — always respecting the evidence semantics: labels
that scope ambiguity (`co_critical`, `role_aware_needed`) or telemetry
quality (`telemetry_limited`) never trigger workload-touching actions.

Actions are *proposals*: the train loop executes TriggerProfiler itself and
surfaces the rest (rank quarantine needs rank->host mapping, which the paper
explicitly warns about — "a recurrent rank is not a node").
"""
from __future__ import annotations

import dataclasses
from collections import deque

from ..core.labeler import (
    CO_CRITICAL,
    DIRECT_EXPOSURE,
    LIKELY_SYNC_WAIT,
    SYNC_WAIT_DEPENDENT,
    TELEMETRY_LIMITED,
)
from ..core.windows import WindowReport

__all__ = ["Action", "MonitorPolicy"]

STRONG_LABELS = (DIRECT_EXPOSURE, SYNC_WAIT_DEPENDENT, LIKELY_SYNC_WAIT)


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str           # trigger_profiler | rebalance_data | quarantine_rank
    #                   # | checkpoint_reshard | none
    window_index: int
    stage: str = ""
    rank: int = -1
    reason: str = ""


@dataclasses.dataclass
class MonitorPolicy:
    """Stateful window-report consumer."""

    #: consecutive telemetry_limited windows with missing ranks before
    #: promoting fail-slow to fail-stop (checkpoint + reshard proposal).
    reshard_after: int = 3
    #: consecutive windows a unique leader rank must persist before a
    #: rank-scoped action is proposed.
    leader_persistence: int = 2
    profiler_cooldown: int = 5

    def __post_init__(self):
        self._missing_streak = 0
        self._leader_history: deque[int] = deque(maxlen=max(2, self.leader_persistence))
        self._last_profile_window = -(10**9)

    def on_report(self, report: WindowReport) -> list[Action]:
        diag = report.diagnosis
        w = report.window_index
        actions: list[Action] = []

        # ---- telemetry-quality track: fail-slow -> fail-stop promotion ----
        if diag.has(TELEMETRY_LIMITED) and not diag.gather_ok:
            self._missing_streak += 1
            if self._missing_streak >= self.reshard_after:
                actions.append(
                    Action(
                        kind="checkpoint_reshard",
                        window_index=w,
                        reason=(
                            f"{self._missing_streak} consecutive windows with "
                            "failed telemetry gather: treat as node fail-slow"
                        ),
                    )
                )
                self._missing_streak = 0
            return actions  # degraded telemetry: no workload actions
        self._missing_streak = 0

        strong = [l for l in diag.labels if l in STRONG_LABELS]
        leader = diag.leader.leader_rank if diag.leader else -1
        self._leader_history.append(leader)
        persistent_leader = (
            leader >= 0
            and len(self._leader_history) >= self.leader_persistence
            and len(set(list(self._leader_history)[-self.leader_persistence:])) == 1
        )

        # ---- profiler routing: strong stage evidence arms a heavy trace ----
        if strong and w - self._last_profile_window >= self.profiler_cooldown:
            actions.append(
                Action(
                    kind="trigger_profiler",
                    window_index=w,
                    stage=diag.routing_stages[0] if diag.routing_stages else "",
                    rank=leader,
                    reason=f"labels={strong} routing={diag.routing_stages[:2]}",
                )
            )
            self._last_profile_window = w

        # ---- straggler mitigation: data-routed persistent unique leader ----
        if (
            persistent_leader
            and diag.routing_stages
            and diag.routing_stages[0].startswith("data.")
            and (strong or diag.has(CO_CRITICAL))
        ):
            actions.append(
                Action(
                    kind="rebalance_data",
                    window_index=w,
                    stage=diag.routing_stages[0],
                    rank=leader,
                    reason=f"persistent data-stage frontier leader rank {leader}",
                )
            )
        return actions
