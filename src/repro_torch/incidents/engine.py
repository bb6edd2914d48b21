"""Incident engine: durable fault identity across windows, jobs, ticks.

The fleet service's `route(k)` is stateless — every window it re-derives
"where to aim the profiler" from scratch, so a persistent drift on one
host shared by three jobs surfaces as three unrelated, flickering route
entries, and nothing says *this is the same fault we flagged 40 windows
ago*.  This module is the missing layer between per-window evidence and
an operator console: it consumes route entries (recoverable seconds from
`core.whatif`, persistence/regime labels from `core.regimes`) and
maintains durable `Incident` objects with a full lifecycle:

    open -> active -> (merged) -> cooling -> resolved

  open      first sighting of a (job, stage, rank-set) candidate;
  active    the same candidate re-surfaced in a later tick or window —
            the fault has identity across windows now;
  merged    absorbed into a fleet-level common-cause incident (the
            member keeps accumulating exposure; the fleet incident
            represents it to the escalation tier);
  cooling   unseen for `cooling_after` ticks — maybe healed, kept warm
            so a flap re-attaches to the SAME incident instead of
            opening a duplicate;
  resolved  unseen through the cooling period ("healed"), or the job
            was evicted while the incident was live ("evicted"), or a
            fleet incident lost its quorum ("members_resolved").

Identity and dedup are deterministic: entries are folded in sorted
(job, stage, rank) order, an entry re-matching a live incident's
rank-set (or, with a declared `Topology`, a sibling rank on the same
host) folds into it, and exposure accumulates at most once per window
index — re-routing the same window every tick never double-counts.
Incident ids are derived from the matched key and opening tick, so any
permutation of one tick's submissions yields the identical incident set.

Cross-job correlation: given per-job activity series and a `Topology`,
the engine scores every topology tier whose nodes appear in >=
`min_jobs` jobs' incident streams (`kernels.frontier.tiered_co_activation`
— ONE launch of the co-activation kernel over the concatenated host +
switch + pod axes folding every job's series, on the CUDA device or as
its plain torch version on the CPU) and promotes each co-activation set
to the NARROWEST tier that explains it: host candidates claim their
member incidents first, then switch candidates gather only
still-unclaimed members, then pod candidates — so three jobs sharing one
faulted host are one host incident, while three faulted hosts under one
switch are ONE switch incident, never three host incidents plus a
duplicate switch view.
Fleet incidents outrank single-job entries in escalation, and wider
fabric tiers outrank narrower ones (`TIER_RANK`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

from .topology import TIERS, Topology

__all__ = [
    "ACTIVE",
    "COOLING",
    "CorrelationGroup",
    "Incident",
    "IncidentEngine",
    "IncidentParams",
    "LIVE_STATES",
    "MERGED",
    "OPEN",
    "RESOLVED",
    "TIER_RANK",
    "activity_meta",
    "fold_host_activity",
]

#: lifecycle states
OPEN = "open"
ACTIVE = "active"
MERGED = "merged"
COOLING = "cooling"
RESOLVED = "resolved"
LIVE_STATES = frozenset({OPEN, ACTIVE, MERGED, COOLING})

#: escalation precedence of the attribution tiers: a wider blast radius
#: outranks a narrower one (a pod incident explains more of the fleet
#: than a switch incident, which explains more than a host incident).
#: Job-scoped incidents carry the host tier.
TIER_RANK = {tier: rank for rank, tier in enumerate(TIERS)}


@dataclasses.dataclass(frozen=True)
class IncidentParams:
    """Thresholds of the incident lifecycle (all deterministic).

    min_recoverable_s: route entries priced at or below this never open
                       an incident (0.0 = any positive price does).
    cooling_after:     ticks unseen before a live incident cools.
    resolve_after:     further unseen ticks before a cooling incident
                       resolves as "healed".
    min_jobs:          distinct jobs required on one (host, stage) for
                       common-cause promotion.
    min_coactive_steps: steps with >= 2 jobs simultaneously active
                       required for promotion (separates a shared live
                       fault from disjoint coincidences).
    retention:         resolved incidents kept for operators (bounded
                       history; oldest pruned first).
    persistence_floor: score floor mirroring `FleetService` routing —
                       a healed incident keeps this fraction of its
                       exposure score.
    """

    min_recoverable_s: float = 0.0
    cooling_after: int = 2
    resolve_after: int = 4
    min_jobs: int = 2
    min_coactive_steps: int = 1
    retention: int = 256
    persistence_floor: float = 0.05


@dataclasses.dataclass(frozen=True)
class CorrelationGroup:
    """One stage-vocabulary cohort of the cross-job correlation.

    The unit of the cross-shard reduce: the coordinator derives groups
    from fleet-wide activity *metadata* (`IncidentEngine.correlation_plan`),
    every shard folds its own jobs' rank-level activity onto the group's
    candidate-host axis (`fold_host_activity` — the per-(host, stage)
    activity partials), and the coordinator stacks the partials in
    `job_ids` order and scores them with the co-activation kernel.  The
    single-process engine runs the exact same plan -> fold -> score
    pipeline over one local partial set, so sharded and unsharded
    promotion decisions are bit-identical by construction.

    The fabric tiers ride the SAME host-folded partials: the plan
    carries each candidate switch/pod axis plus the host-column ->
    node-column groupings (`tier_axes`), and the scoring side
    OR-collapses the stacked host partials onto them — nothing
    tier-shaped ever crosses a shard boundary, so the sharded reduce is
    tier-aware by construction and stays bit-identical to unsharded.
    """

    #: the group's shared stage vocabulary
    stages: tuple[str, ...]
    #: member job ids, sorted — the stacking order of the job axis
    job_ids: tuple[str, ...]
    #: aligned history depth: every member's most recent `n_steps` steps
    n_steps: int
    #: candidate host axis, sorted: hosts touched by a member job that
    #: sit under ANY candidate node (their own host tier, their switch,
    #: or their pod) — a host whose switch is shared by >= min_jobs
    #: members folds in even when the host itself is private to one job.
    hosts: tuple[str, ...]
    #: candidate switch axis (switches >= min_jobs members touch), sorted
    switches: tuple[str, ...] = ()
    #: per host column: index into `switches`, -1 = not a candidate
    switch_of: tuple[int, ...] = ()
    #: candidate pod axis (pods >= min_jobs members touch), sorted
    pods: tuple[str, ...] = ()
    #: per host column: index into `pods`, -1 = not a candidate
    pod_of: tuple[int, ...] = ()

    def tier_axes(self) -> list:
        """The fabric tiers as kernel `TierAxes` (empty axes dropped) —
        the aggregation maps `tiered_co_activation` scores over."""
        from ..kernels.frontier import TierAxes

        axes = []
        if self.switches:
            axes.append(
                TierAxes("switch", len(self.switches), self.switch_of)
            )
        if self.pods:
            axes.append(TierAxes("pod", len(self.pods), self.pod_of))
        return axes


def activity_meta(
    activity: Mapping[str, tuple[np.ndarray, tuple[str, ...]]],
) -> dict[str, tuple[int, tuple[str, ...]]]:
    """Correlation metadata of a per-job activity mapping: job id ->
    (usable step depth, stage vocabulary).

    Applies the engine's admission rules (3-D series, nonzero steps,
    stage axis matching the vocabulary) so a `correlation_plan` built
    from merged per-shard metadata sees exactly the jobs the
    single-process fold would."""
    meta: dict[str, tuple[int, tuple[str, ...]]] = {}
    for job_id in sorted(activity):
        act, stages = activity[job_id]
        act = np.asarray(act)
        if act.ndim != 3 or act.shape[0] == 0:
            continue
        if act.shape[2] != len(stages):
            continue
        meta[job_id] = (int(act.shape[0]), tuple(stages))
    return meta


def fold_host_activity(
    group: CorrelationGroup,
    activity: Mapping[str, tuple[np.ndarray, tuple[str, ...]]],
    topology: Topology,
) -> dict[str, np.ndarray]:
    """Fold rank-level activity onto `group`'s candidate-host axis.

    The shard-side half of the cross-shard reduce: for every group
    member present in `activity`, collapse its ``act[N, R, S]`` bool
    series over each host's ranks onto ``[n_steps, H_cand, S]`` (any
    rank of the host active => the host is active), aligned on the most
    recent `group.n_steps` steps.  Jobs outside the group (or absent
    from this shard's `activity`) are simply not emitted — the
    coordinator stacks partials from every shard in `group.job_ids`
    order.

    Fabric tiers need nothing extra here: switch/pod activity is
    derivable from these host partials (`group.tier_axes` OR-collapse,
    applied scoring-side), so the shard wire format is tier-agnostic
    and sharded tier promotion stays bit-identical to unsharded."""
    hcol = {h: i for i, h in enumerate(group.hosts)}
    out: dict[str, np.ndarray] = {}
    for job_id in group.job_ids:
        if job_id not in activity:
            continue
        act, _ = activity[job_id]
        act = np.asarray(act).astype(bool)
        job_hosts = topology.hosts_for(job_id)
        a_host = np.zeros(
            (group.n_steps, len(group.hosts), len(group.stages)), bool
        )
        tail = act[-group.n_steps:]
        for rank in range(min(act.shape[1], len(job_hosts))):
            col = hcol.get(job_hosts[rank])
            if col is not None:
                a_host[:, col, :] |= tail[:, rank, :]
        out[job_id] = a_host
    return out


@dataclasses.dataclass
class Incident:
    """One durable fault, job-scoped or fleet-scoped."""

    incident_id: str
    scope: str                    # "job" | "fleet"
    job_id: str                   # "" for fleet scope
    stage: str
    ranks: tuple[int, ...]        # sorted rank-set (job scope; () fleet)
    host: str                     # common-cause node name; "" undeclared
    state: str
    opened_tick: int
    last_seen_tick: int
    #: attribution tier of `host` — "host" | "switch" | "pod" (see
    #: `topology.TIERS`).  Job-scoped incidents are always host-tier;
    #: a fleet incident carries the NARROWEST tier that explains its
    #: co-activation set.
    tier: str = "host"
    onset_step: int = -1          # job-global onset from the first entry
    last_window_index: int = -1
    windows_seen: int = 0
    exposure_s: float = 0.0       # accumulated recoverable seconds
    recoverable_s: float = 0.0    # latest per-window estimate
    regime: str = ""
    persistence: float = 1.0
    resolve_reason: str = ""
    merged_into: str = ""         # job scope: owning fleet incident id
    members: tuple[str, ...] = () # fleet scope: member incident ids
    member_jobs: tuple[str, ...] = ()  # fleet scope: member job ids
    escalations: int = 0
    last_escalated_tick: int = -(10 ** 9)

    @property
    def live(self) -> bool:
        return self.state in LIVE_STATES

    def score(self, floor: float = 0.05) -> float:
        """Escalation score: accumulated exposure x persistence (floored,
        mirroring the fleet routing weight)."""
        return self.exposure_s * (floor + (1.0 - floor) * self.persistence)

    def as_row(self) -> dict:
        """Flat summary row for consoles / serving output."""
        return {
            "id": self.incident_id,
            "scope": self.scope,
            "job": self.job_id,
            "stage": self.stage,
            "ranks": list(self.ranks),
            "host": self.host,
            "tier": self.tier,
            "state": self.state,
            "exposure_s": round(self.exposure_s, 4),
            "regime": self.regime,
            "persistence": round(self.persistence, 3),
            "onset_step": self.onset_step,
            "opened_tick": self.opened_tick,
            "windows": self.windows_seen,
            "escalations": self.escalations,
            "resolve_reason": self.resolve_reason,
            "member_jobs": list(self.member_jobs),
        }


class IncidentEngine:
    """Durable cross-window, cross-job fault tracker.

    Feed it once per fleet tick (`observe`) with the tick's route
    entries, the evicted job ids, and (optionally) per-job activity
    series for common-cause correlation.  All state is bounded: live
    incidents are bounded by the fleet's candidate count, resolved
    history by `params.retention`.
    """

    def __init__(
        self,
        *,
        topology: Topology | None = None,
        params: IncidentParams | None = None,
        device="cuda",
    ):
        self.topology = topology if topology is not None else Topology()
        self.params = params or IncidentParams()
        #: where the co-activation scores run: "cuda" launches the
        #: hand-written kernel; "cpu" runs its plain torch version (the
        #: tests).  Integer statistics, so the two agree exactly; never
        #: falls back from one to the other.
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "IncidentEngine(device='cuda'): no CUDA device is available "
                "(pass device='cpu' to run the plain co-activation on the CPU)"
            )
        self._job_incidents: dict[tuple[str, str], list[Incident]] = {}
        self._fleet_incidents: dict[tuple[str, str], Incident] = {}
        self._resolved: list[Incident] = []
        self.opened_total = 0
        self.merged_total = 0
        self.resolved_total = 0

    # -- reads -------------------------------------------------------------

    def incidents(self, *, live_only: bool = True) -> list[Incident]:
        """All incidents: fleet scope first, wider fabric tiers before
        narrower (pod > switch > host — `TIER_RANK`), then score, then
        id — the same total order `EscalationController` ranks by."""
        out = [i for i in self._iter_live()]
        if not live_only:
            out.extend(self._resolved)
        out.sort(
            key=lambda i: (
                i.scope != "fleet",
                -TIER_RANK.get(i.tier, 0),
                -i.score(self.params.persistence_floor),
                i.incident_id,
            )
        )
        return out

    def get(self, incident_id: str) -> Incident | None:
        for inc in self._iter_live():
            if inc.incident_id == incident_id:
                return inc
        for inc in self._resolved:
            if inc.incident_id == incident_id:
                return inc
        return None

    def counts(self) -> dict[str, int]:
        """Live incidents per state (+ lifetime resolved, + lifetime
        topology re-homings — the conflicting-claims counter)."""
        out = {OPEN: 0, ACTIVE: 0, MERGED: 0, COOLING: 0, RESOLVED: 0}
        for inc in self._iter_live():
            out[inc.state] += 1
        out[RESOLVED] = self.resolved_total
        out["rehomed"] = self.topology.rehomed
        return out

    def table(self, *, live_only: bool = True) -> list[dict]:
        return [i.as_row() for i in self.incidents(live_only=live_only)]

    def _iter_live(self) -> Iterable[Incident]:
        for incs in self._job_incidents.values():
            yield from incs
        yield from self._fleet_incidents.values()

    # -- the per-tick fold -------------------------------------------------

    def observe(
        self,
        tick: int,
        entries: Sequence[Any],
        *,
        evicted: Sequence[str] = (),
        activity: Mapping[str, tuple[np.ndarray, tuple[str, ...]]]
        | None = None,
        folded: Sequence[tuple[CorrelationGroup, np.ndarray]] | None = None,
    ) -> list[Incident]:
        """Fold one fleet tick; returns the live incidents (sorted).

        `entries` are route-entry-shaped records (``job_id``, ``stage``,
        ``rank``, ``recoverable_s``, ``regime``, ``persistence``,
        ``onset_step``, ``window_index`` — `fleet.service.RouteEntry`
        satisfies this); `activity` maps job_id to its
        ``(act[N, R, S] bool, stage names)`` thresholded activity series
        (see `core.streaming.StreamingRegimes.activity`), the substrate
        of cross-job correlation.

        `folded` is the sharded-coordinator alternative to `activity`:
        pre-reduced ``(CorrelationGroup, act[J, N, H_cand, S])`` pairs
        (shard partials from `fold_host_activity`, stacked in
        ``group.job_ids`` order) — the engine scores them directly
        instead of folding rank-level series itself.  Passing both is an
        error: one tick has exactly one correlation substrate.
        """
        if activity and folded:
            raise ValueError(
                "pass either per-job `activity` or pre-reduced `folded` "
                "partials, not both"
            )
        for job_id in sorted(set(evicted)):
            self._resolve_job(job_id, tick, reason="evicted")
            self.topology.forget(job_id)
        # deterministic fold order: a TOTAL key over every field the
        # fold reads, so any permutation of this tick's submissions —
        # including duplicate candidates differing only in window or
        # price — yields the identical incident set and ids.
        for e in sorted(
            entries,
            key=lambda e: (
                e.job_id,
                e.stage,
                e.rank,
                e.window_index,
                e.recoverable_s,
                e.persistence,
                e.onset_step,
                e.regime,
            ),
        ):
            self._fold_entry(tick, e)
        self._sweep(tick)
        if activity:
            self._correlate(tick, activity)
        elif folded:
            self.correlate_folded(tick, folded)
        self._refresh_fleet(tick)
        self._prune()
        return self.incidents()

    # -- single-job identity -----------------------------------------------

    def _fold_entry(self, tick: int, e: Any) -> None:
        if e.recoverable_s <= self.params.min_recoverable_s:
            return
        key = (e.job_id, e.stage)
        incs = self._job_incidents.setdefault(key, [])
        inc = self._match(incs, e)
        if inc is None:
            inc = Incident(
                incident_id=(
                    f"ij:{e.job_id}:{e.stage}:r{max(e.rank, -1)}:t{tick}"
                ),
                scope="job",
                job_id=e.job_id,
                stage=e.stage,
                ranks=(e.rank,) if e.rank >= 0 else (),
                host=self.topology.host_of(e.job_id, e.rank),
                state=OPEN,
                opened_tick=tick,
                last_seen_tick=tick,
            )
            incs.append(inc)
            self.opened_total += 1
        else:
            if e.rank >= 0 and e.rank not in inc.ranks:
                inc.ranks = tuple(sorted((*inc.ranks, e.rank)))
            if inc.state in (OPEN, COOLING) and tick > inc.last_seen_tick:
                # re-surfaced in a later tick: confirmed identity (a
                # cooling incident flaps back instead of duplicating)
                inc.state = ACTIVE
            inc.last_seen_tick = tick
        if not inc.host and e.rank >= 0:
            inc.host = self.topology.host_of(e.job_id, e.rank)
        # exposure accumulates once per window, MONOTONICALLY — the same
        # window re-routed on later ticks never double-counts, and
        # neither does a transport re-delivering an older window after a
        # newer one.  Entries that cannot declare a window coordinate
        # (window_index < 0, pre-whatif emitters) count exactly once.
        new_window = (
            e.window_index > inc.last_window_index
            if e.window_index >= 0
            else inc.windows_seen == 0
        )
        if new_window:
            inc.exposure_s += e.recoverable_s
            inc.windows_seen += 1
            inc.last_window_index = max(
                inc.last_window_index, e.window_index
            )
            if inc.windows_seen >= 2 and inc.state == OPEN:
                inc.state = ACTIVE
        inc.recoverable_s = e.recoverable_s
        inc.regime = e.regime
        inc.persistence = e.persistence
        if inc.onset_step < 0 and e.onset_step >= 0:
            inc.onset_step = e.onset_step

    def _match(self, incs: list[Incident], e: Any) -> Incident | None:
        """Window-to-window identity: exact rank membership first, then
        same-host siblings (two ranks of one host are one fault)."""
        live = [i for i in incs if i.live]
        for inc in live:
            if e.rank in inc.ranks:
                return inc
        host = self.topology.host_of(e.job_id, e.rank)
        if host:
            for inc in live:
                if inc.host == host:
                    return inc
        return None

    # -- lifecycle sweep ---------------------------------------------------

    def _sweep(self, tick: int) -> None:
        p = self.params
        for incs in self._job_incidents.values():
            for inc in incs:
                if not inc.live:
                    continue
                unseen = tick - inc.last_seen_tick
                if inc.state in (OPEN, ACTIVE, MERGED):
                    if unseen >= p.cooling_after:
                        inc.state = COOLING
                        if inc.merged_into:
                            inc.merged_into = ""
                elif inc.state == COOLING:
                    if unseen >= p.cooling_after + p.resolve_after:
                        self._resolve(inc, tick, reason="healed")

    def _resolve(self, inc: Incident, tick: int, *, reason: str) -> None:
        inc.state = RESOLVED
        inc.resolve_reason = reason
        inc.merged_into = ""
        self.resolved_total += 1
        self._resolved.append(inc)

    def _resolve_job(self, job_id: str, tick: int, *, reason: str) -> None:
        """A job left the fleet: every live incident of it resolves NOW —
        an evicted job's incident must never linger as live."""
        for (jid, _), incs in self._job_incidents.items():
            if jid != job_id:
                continue
            for inc in incs:
                if inc.live:
                    self._resolve(inc, tick, reason=reason)

    # -- cross-job common cause --------------------------------------------

    def correlation_plan(
        self, meta: Mapping[str, tuple[int, tuple[str, ...]]]
    ) -> list[CorrelationGroup]:
        """Derive the tick's correlation groups from fleet-wide activity
        METADATA (job id -> (step depth, stage vocabulary) — see
        `activity_meta`); no activity tensors are touched.

        Jobs group by stage vocabulary; within a group they align on
        their most recent COMMON history (regime rings may hold
        different depths — a job that joined the fleet a window late
        must still co-activate with its host peers), and the dense host
        axis holds only the hosts that >= min_jobs of the group's jobs
        can touch — the only promotable ones, so per-tick cost scales
        with *shared* hosts, never the fleet's full host count.  Groups
        that cannot promote (too few members, no shared host) are
        dropped here, before any activity is folded or shipped.

        This is the coordinator half of the cross-shard reduce: the
        plan is computed once from merged metadata, every shard folds
        its jobs' activity against it (`fold_host_activity`), and the
        stacked partials go through `correlate_folded`.
        """
        p = self.params
        if not len(self.topology):
            return []
        groups: dict[tuple[str, ...], list[str]] = {}
        depth: dict[str, int] = {}
        for job_id in sorted(meta):
            if job_id not in self.topology:
                continue
            n_steps, stages = meta[job_id]
            if n_steps <= 0:
                continue
            groups.setdefault(tuple(stages), []).append(job_id)
            depth[job_id] = int(n_steps)
        out: list[CorrelationGroup] = []
        for stages, members in sorted(groups.items()):
            if len(members) < p.min_jobs:
                continue
            # per-tier membership counts: how many member jobs touch
            # each host / switch / pod (a job counts once per node).
            counts: dict[str, dict[str, int]] = {t: {} for t in TIERS}
            touched: set[str] = set()
            for job_id in members:
                job_hosts = set(self.topology.hosts_for(job_id))
                touched |= job_hosts
                for tier in TIERS:
                    for node in {
                        n
                        for h in job_hosts
                        if (n := self.topology.node_of(tier, h))
                    }:
                        counts[tier][node] = counts[tier].get(node, 0) + 1
            cand_sw = sorted(
                n for n, c in counts["switch"].items() if c >= p.min_jobs
            )
            cand_pod = sorted(
                n for n, c in counts["pod"].items() if c >= p.min_jobs
            )
            # candidate hosts: touched hosts that sit under ANY
            # candidate node — shared directly, or privately held but
            # under a shared switch/pod (those must fold in so the
            # wider tier can see their activity).
            sw_set, pod_set = set(cand_sw), set(cand_pod)
            cand_hosts = sorted(
                h
                for h in touched
                if counts["host"].get(h, 0) >= p.min_jobs
                or self.topology.switch_of(h) in sw_set
                or self.topology.pod_of(h) in pod_set
            )
            if not cand_hosts:
                continue
            sw_col = {n: i for i, n in enumerate(cand_sw)}
            pod_col = {n: i for i, n in enumerate(cand_pod)}
            out.append(
                CorrelationGroup(
                    stages=stages,
                    job_ids=tuple(members),
                    n_steps=min(depth[j] for j in members),
                    hosts=tuple(cand_hosts),
                    switches=tuple(cand_sw),
                    switch_of=tuple(
                        sw_col.get(self.topology.switch_of(h), -1)
                        for h in cand_hosts
                    ),
                    pods=tuple(cand_pod),
                    pod_of=tuple(
                        pod_col.get(self.topology.pod_of(h), -1)
                        for h in cand_hosts
                    ),
                )
            )
        return out

    def correlate_folded(
        self,
        tick: int,
        folded: Sequence[tuple[CorrelationGroup, np.ndarray]],
    ) -> None:
        """Score pre-reduced host-folded activity and promote matches.

        `folded` pairs each `CorrelationGroup` of the tick's plan with
        its stacked partials ``act[J, N, H_cand, S]`` (J in
        ``group.job_ids`` order — across shards, the coordinator
        reassembles that order before calling).  This is the ONE scoring
        path: the single-process `activity` route reduces to it, so a
        sharded fleet's promotion decisions are bit-identical."""
        p = self.params
        for group, act in folded:
            act = np.asarray(act)
            if act.shape[0] == 0:
                continue
            tiers = group.tier_axes()
            stats = self._co_activation(act, tiers)
            # narrowest tier first: host candidates claim their member
            # incidents, then switch candidates gather only
            # still-unclaimed members, then pod — three faulted hosts
            # under one switch become ONE switch incident; a genuinely
            # shared host never re-appears as a duplicate switch view.
            claimed: set[str] = set()
            node_axis = {"switch": group.switches, "pod": group.pods}
            scored = [(stats[0], "host", group.hosts)] + [
                (pkt, axes.tier, node_axis[axes.tier])
                for pkt, axes in zip(stats[1:], tiers)
            ]
            for pkt, tier, nodes in scored:
                jobs = np.asarray(pkt.jobs)        # [S, nodes]
                coact = np.asarray(pkt.coact)      # [S, nodes]
                cand = np.argwhere(
                    (jobs >= p.min_jobs) & (coact >= p.min_coactive_steps)
                )
                for si, ni in cand:
                    self._promote(
                        tick,
                        group.stages[si],
                        nodes[ni],
                        tier=tier,
                        claimed=claimed,
                    )

    def _correlate(
        self,
        tick: int,
        activity: Mapping[str, tuple[np.ndarray, tuple[str, ...]]],
    ) -> None:
        """Single-process correlation: plan -> fold -> score, over one
        local partial set (the same pipeline a sharded coordinator runs
        distributed — see `CorrelationGroup`)."""
        plan = self.correlation_plan(activity_meta(activity))
        folded = []
        for group in plan:
            parts = fold_host_activity(group, activity, self.topology)
            folded.append(
                (group, np.stack([parts[j] for j in group.job_ids]))
            )
        self.correlate_folded(tick, folded)

    def _co_activation(self, act: np.ndarray, tiers: Sequence[Any] = ()):
        """Per-tier co-activation packets, host tier first, as NumPy
        arrays: one launch on `self.device`, and the counts come back to
        the host in one copy (exact integer statistics on both devices)."""
        from ..kernels.frontier import CoActivationPacket, tiered_co_activation

        stats = tiered_co_activation(act, tiers, device=self.device)
        widths = [pkt.jobs.shape[1] for pkt in stats]
        flat = torch.cat([t for pkt in stats for t in pkt], dim=1).cpu().numpy()
        out, lo = [], 0
        for w in widths:
            out.append(CoActivationPacket(
                *(flat[:, lo + k * w: lo + (k + 1) * w] for k in range(3))
            ))
            lo += 3 * w
        return out

    def _promote(
        self,
        tick: int,
        stage: str,
        node: str,
        *,
        tier: str = "host",
        claimed: set[str] | None = None,
    ) -> None:
        """Merge the live single-job incidents under (`tier`, `node`,
        `stage`) into one fleet-level incident (>= min_jobs distinct
        jobs required).

        `claimed` is the narrowest-tier guard: member ids a narrower
        tier already merged this tick are skipped, and on success this
        candidate's members are added — so a switch candidate only
        forms from hosts no host candidate explained, and a pod only
        from what no switch explained.  A candidate whose unclaimed
        members fall below quorum simply never opens."""
        members: list[Incident] = []
        for (job_id, inc_stage), incs in sorted(
            self._job_incidents.items()
        ):
            if inc_stage != stage:
                continue
            under = set(self.topology.ranks_under(tier, job_id, node))
            for inc in incs:
                if not inc.live:
                    continue
                if claimed is not None and inc.incident_id in claimed:
                    continue
                if set(inc.ranks) & under or (
                    inc.host
                    and self.topology.node_of(tier, inc.host) == node
                ):
                    members.append(inc)
        if len({m.job_id for m in members}) < self.params.min_jobs:
            return
        key = (tier, node, stage)
        fleet = self._fleet_incidents.get(key)
        if fleet is None or not fleet.live:
            prefix = "if" if tier == "host" else f"if:{tier}"
            fleet = Incident(
                incident_id=f"{prefix}:{node}:{stage}:t{tick}",
                scope="fleet",
                job_id="",
                stage=stage,
                ranks=(),
                host=node,
                state=OPEN,
                opened_tick=tick,
                last_seen_tick=tick,
                tier=tier,
            )
            self._fleet_incidents[key] = fleet
            self.merged_total += 1
        for m in members:
            if m.merged_into != fleet.incident_id:
                m.merged_into = fleet.incident_id
            m.state = MERGED
        if claimed is not None:
            claimed.update(m.incident_id for m in members)
        fleet.members = tuple(sorted(m.incident_id for m in members))
        fleet.member_jobs = tuple(sorted({m.job_id for m in members}))
        fleet.last_seen_tick = tick
        if fleet.state == COOLING or (
            fleet.state == OPEN and tick > fleet.opened_tick
        ):
            fleet.state = ACTIVE

    def _refresh_fleet(self, tick: int) -> None:
        """Derive each fleet incident from its members; demote on lost
        quorum, cool/resolve on silence, release members on resolve."""
        p = self.params
        for key, fleet in sorted(self._fleet_incidents.items()):
            if not fleet.live:
                continue
            members = [
                inc
                for inc in self._iter_live()
                if inc.scope == "job"
                and inc.merged_into == fleet.incident_id
                and inc.state == MERGED
            ]
            if members:
                fleet.members = tuple(
                    sorted(m.incident_id for m in members)
                )
                fleet.member_jobs = tuple(
                    sorted({m.job_id for m in members})
                )
                fleet.exposure_s = sum(m.exposure_s for m in members)
                fleet.recoverable_s = sum(m.recoverable_s for m in members)
                fleet.persistence = max(m.persistence for m in members)
                best = max(members, key=lambda m: m.exposure_s)
                fleet.regime = best.regime
                onsets = [m.onset_step for m in members if m.onset_step >= 0]
                fleet.onset_step = min(onsets) if onsets else -1
            quorum = len({m.job_id for m in members}) >= p.min_jobs
            unseen = tick - fleet.last_seen_tick
            if not quorum and fleet.state in (OPEN, ACTIVE):
                # lost its members (healed / evicted / cooled): the
                # common cause is gone — release survivors to their own
                # lifecycle and resolve the fleet view.
                for m in members:
                    m.state = ACTIVE
                    m.merged_into = ""
                self._resolve(fleet, tick, reason="members_resolved")
            elif fleet.state in (OPEN, ACTIVE) and unseen >= p.cooling_after:
                fleet.state = COOLING
            elif (
                fleet.state == COOLING
                and unseen >= p.cooling_after + p.resolve_after
            ):
                for m in members:
                    m.state = ACTIVE
                    m.merged_into = ""
                self._resolve(fleet, tick, reason="healed")

    # -- bounded history ---------------------------------------------------

    def _prune(self) -> None:
        keep = self.params.retention
        if len(self._resolved) > keep:
            del self._resolved[: len(self._resolved) - keep]
        # resolved incidents leave the live maps entirely
        for key in [
            k
            for k, incs in self._job_incidents.items()
            if not any(i.live for i in incs)
        ]:
            del self._job_incidents[key]
        for key, incs in self._job_incidents.items():
            incs[:] = [i for i in incs if i.live]
        for key in [
            k for k, f in self._fleet_incidents.items() if not f.live
        ]:
            del self._fleet_incidents[key]
