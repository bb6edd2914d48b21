"""Budgeted profiler escalation: the paper's routing claim, operational.

The routing answer says where a heavy profiler is worth aiming; this
controller decides *which of those attachments actually happen*, under a
hard per-tick budget.  Heavy profilers are expensive (they perturb the
very jobs being diagnosed), so production escalation is budgeted and
hysteretic — a flapping incident must not drain the budget that a
steady, expensive one needs.

Mechanics (all deterministic):

  * a **token bucket** refills `budget_per_tick` tokens per fleet tick
    up to `bucket_cap` (unused budget carries over, bounded), and each
    emitted action consumes one token;
  * emissions per tick are additionally HARD-capped at
    `budget_per_tick` — the bucket smooths bursts, it never licenses
    exceeding the per-tick budget;
  * candidates are the live, un-merged incidents (fleet-scope
    common-cause incidents outrank every single-job incident), ranked
    by accumulated-recoverable x persistence, ties broken by incident
    id;
  * **hysteresis**: an incident escalated at tick T is ineligible until
    ``T + hysteresis_ticks``, and a cooling incident is never escalated
    — so open/cool flapping cannot re-consume tokens every flap.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .engine import ACTIVE, Incident, OPEN, TIER_RANK

__all__ = ["EscalationController", "ProfilerAction"]


@dataclasses.dataclass(frozen=True)
class ProfilerAction:
    """One 'attach a heavy profiler to (job, host, stage)' decision."""

    incident_id: str
    job_id: str                  # "" for fleet-scope incidents
    jobs: tuple[str, ...]        # member jobs (fleet) or (job_id,)
    host: str
    stage: str
    ranks: tuple[int, ...]
    tick: int
    score: float


class EscalationController:
    """Token-bucket escalation over an incident stream."""

    def __init__(
        self,
        *,
        budget_per_tick: int = 2,
        bucket_cap: int | None = None,
        hysteresis_ticks: int = 3,
        persistence_floor: float = 0.05,
    ):
        if budget_per_tick < 1:
            raise ValueError("budget_per_tick must be >= 1")
        self.budget_per_tick = budget_per_tick
        self.bucket_cap = (
            2 * budget_per_tick if bucket_cap is None else bucket_cap
        )
        if self.bucket_cap < budget_per_tick:
            raise ValueError("bucket_cap must be >= budget_per_tick")
        self.hysteresis_ticks = hysteresis_ticks
        self.persistence_floor = persistence_floor
        self._tokens = budget_per_tick   # first tick never exceeds budget
        self._last_tick: int | None = None
        self._emitted_this_tick = 0
        self.actions_total = 0

    @property
    def tokens(self) -> int:
        return self._tokens

    def plan(
        self, tick: int, incidents: Sequence[Incident]
    ) -> list[ProfilerAction]:
        """Emit this tick's profiler attachments (at most
        `budget_per_tick`, never more than the bucket holds) and mark
        the escalated incidents.

        Call once per fleet tick with the engine's live incidents; ticks
        may skip (the bucket refills per elapsed tick, capped).
        """
        if self._last_tick is not None and tick > self._last_tick:
            self._tokens = min(
                self.bucket_cap,
                self._tokens + (tick - self._last_tick) * self.budget_per_tick,
            )
        if tick != self._last_tick:
            # the per-tick HARD cap holds even if plan() is called more
            # than once for the same tick (carried-over tokens must not
            # leak past it through a second call)
            self._emitted_this_tick = 0
        self._last_tick = tick

        eligible = [
            inc
            for inc in incidents
            if inc.state in (OPEN, ACTIVE)
            and not inc.merged_into
            and inc.exposure_s > 0.0
            and tick - inc.last_escalated_tick >= self.hysteresis_ticks
        ]
        eligible.sort(
            key=lambda i: (
                i.scope != "fleet",                   # fleet outranks job
                -TIER_RANK.get(i.tier, 0),            # pod > switch > host
                -i.score(self.persistence_floor),
                i.incident_id,
            )
        )
        budget = min(
            self.budget_per_tick - self._emitted_this_tick, self._tokens
        )
        actions: list[ProfilerAction] = []
        for inc in eligible[: max(0, budget)]:
            jobs = (
                inc.member_jobs if inc.scope == "fleet" else (inc.job_id,)
            )
            actions.append(
                ProfilerAction(
                    incident_id=inc.incident_id,
                    job_id=inc.job_id,
                    jobs=jobs,
                    host=inc.host,
                    stage=inc.stage,
                    ranks=inc.ranks,
                    tick=tick,
                    score=inc.score(self.persistence_floor),
                )
            )
            inc.escalations += 1
            inc.last_escalated_tick = tick
        self._tokens -= len(actions)
        self._emitted_this_tick += len(actions)
        self.actions_total += len(actions)
        return actions
