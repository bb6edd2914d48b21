"""Discrete-event multi-rank simulator with exact synchronization-
displacement semantics (the paper's hidden-rank evaluation substrate).

Model: each rank advances an absolute host clock through the ordered stages
of each step.  A stage in `sync_stages` ends with a group synchronization
(DDP allreduce in backward, FSDP all-gather in forward, ...): every rank
leaves it at max_r(arrival) (+ optional collective duration), and the wait
is charged to that stage on the waiting ranks — exactly the "charged where
the host observes it" rule.  Steps run host-serially, so a tail delay on
one rank (e.g. a host-only callback) surfaces as *next-step* sync wait on
the others: the cross-step displacement that defeats per-stage max/average
summaries.

Fault modes — and the counterfactual ground truth each implies
---------------------------------------------------------------
The simulator is the what-if engine's oracle: because delay is injected
explicitly, each mode fixes what a perfect intervention could recover
(`repro.sim.scenarios.injected_recoverable` computes it per candidate).

  host          delay added to the rank's stage span (host-visible there).
                When the seeded stage is NOT a barrier stage, the delay is
                observed on the faulted rank before the group reacts:
                rank-attributable, and the sync-aware counterfactual
                (`core.whatif`) recovers both the local span and the wait
                it would have displaced onto the group — ~delay_s per
                active step, a true lower bound on a fix.  When the seeded
                stage IS a barrier stage the release shifts for everyone
                and the observed rows match a slow collective exactly:
                group-ambiguous, priced ~0 and flagged
                `sync_stage_ambiguous` (see `scenarios.
                attributable_recoverable`).
  comm          the collective itself is slow: delay added to the sync
                release time, so EVERY rank observes it in the sync stage.
                Group-wide: no single-rank substitution removes it (and
                the work imputation absorbs it, since all ranks inflate
                together) — the correct what-if answer is ~0, flagged
                `group_wide` / `sync_stage_ambiguous`, routing the
                operator to the fabric rather than a rank.
                `ramp_steps > 0` turns a host fault into a slow-drift
                onset (thermal-throttle shape): the delay ramps linearly
                from ~0 to `delay_s` over that many active steps, then
                holds — the temporal regime engine (`core.regimes`) must
                read it as persistent with a positive trend slope.
  spillover     device work launched in `stage` becomes host-visible in
                `spill_to` (the paper's forward/device family): only
                (1-spill_frac) of the delay lands in the seeded stage, the
                rest in the spill target.  The ground truth splits the
                same way across the two (stage, rank) candidates; both sit
                on the same rank, so the rank localization stays exact
                even when the stage attribution is split — except for any
                piece that lands in a barrier stage, which is
                group-ambiguous per the `host` rule above.

Role groups (`Scenario.roles`) synchronize independently: a fault in one
role group never displaces wait into another, which is why role-aware
(grouped) diagnosis is exact per group.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.contract import StageSchema

__all__ = ["ClusterSpec", "Fault", "Scenario", "SimResult", "simulate"]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Physical placement of a job's ranks: which host serves each rank,
    and (optionally) which fabric node sits above each host.

    The simulator itself is placement-blind (delay is injected per rank),
    but the incident tier (`repro.incidents`) correlates faults ACROSS
    jobs by topology node, so scenarios must state their topology
    explicitly instead of implying it in scenario code.  `hosts[r]` is
    the host name of rank r; several ranks on the same name share that
    host (and a host-level fault hits all of them).  `switches[r]` /
    `pods[r]` name the fabric tiers above rank r's host — per-rank and
    aligned with `hosts`, matching the SFP2-v3 wire layout, so a
    scenario's placement feeds `telemetry.from_diagnosis` verbatim.
    Empty tuples mean that tier is undeclared (host-only placement).
    """

    world_size: int
    hosts: tuple[str, ...]           # per-rank host name, len == world_size
    #: per-rank switch name above each host (() = fabric undeclared)
    switches: tuple[str, ...] = ()
    #: per-rank pod name above each switch (() = undeclared; requires
    #: `switches` — a pod hangs from a switch, never from a bare host)
    pods: tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.hosts) != self.world_size:
            raise ValueError(
                f"hosts must name every rank: expected {self.world_size}, "
                f"got {len(self.hosts)}"
            )
        if self.switches and len(self.switches) != self.world_size:
            raise ValueError(
                f"switches must align with hosts: expected "
                f"{self.world_size}, got {len(self.switches)}"
            )
        if self.pods and not self.switches:
            raise ValueError("pods require switches (tiered placement)")
        if self.pods and len(self.pods) != self.world_size:
            raise ValueError(
                f"pods must align with hosts: expected {self.world_size}, "
                f"got {len(self.pods)}"
            )

    @staticmethod
    def uniform(
        world_size: int, ranks_per_host: int, *, prefix: str = "host"
    ) -> "ClusterSpec":
        """Contiguous packing: ranks [k*P, (k+1)*P) live on `prefix-k`."""
        if ranks_per_host < 1:
            raise ValueError("ranks_per_host must be >= 1")
        return ClusterSpec(
            world_size=world_size,
            hosts=tuple(
                f"{prefix}-{r // ranks_per_host}" for r in range(world_size)
            ),
        )

    @staticmethod
    def fabric(
        world_size: int,
        ranks_per_host: int,
        *,
        hosts_per_switch: int = 4,
        switches_per_pod: int = 4,
        prefix: str = "host",
    ) -> "ClusterSpec":
        """Contiguous TIERED packing: ranks pack onto hosts
        (`uniform`), hosts onto switches (`{prefix}-sw-k`), switches
        onto pods (`{prefix}-pod-k`) — the full rank -> host -> switch
        -> pod hierarchy for fabric-aware scenarios and drivers."""
        if hosts_per_switch < 1 or switches_per_pod < 1:
            raise ValueError(
                "hosts_per_switch and switches_per_pod must be >= 1"
            )
        base = ClusterSpec.uniform(world_size, ranks_per_host, prefix=prefix)
        host_idx = [r // ranks_per_host for r in range(world_size)]
        sw_idx = [h // hosts_per_switch for h in host_idx]
        return ClusterSpec(
            world_size=world_size,
            hosts=base.hosts,
            switches=tuple(f"{prefix}-sw-{s}" for s in sw_idx),
            pods=tuple(
                f"{prefix}-pod-{s // switches_per_pod}" for s in sw_idx
            ),
        )

    def host_of(self, rank: int) -> str:
        return self.hosts[rank]

    def host_ranks(self) -> dict[str, tuple[int, ...]]:
        """host name -> ranks it serves (insertion-ordered, deterministic)."""
        out: dict[str, list[int]] = {}
        for r, h in enumerate(self.hosts):
            out.setdefault(h, []).append(r)
        return {h: tuple(rs) for h, rs in out.items()}

    def ranks_on(self, host: str) -> tuple[int, ...]:
        return tuple(r for r, h in enumerate(self.hosts) if h == host)


@dataclasses.dataclass(frozen=True)
class Fault:
    rank: int
    stage: str
    delay_s: float
    mode: str = "host"               # host | comm | spillover
    spill_to: str = ""
    spill_frac: float = 0.8
    start_step: int = 0
    end_step: int | None = None      # exclusive; None = all steps
    #: > 0 = slow-drift onset: the delay ramps linearly from ~0 to
    #: `delay_s` over this many active steps (a thermal-throttle shape),
    #: then holds.  0 = step-function onset (the classic fault families).
    ramp_steps: int = 0

    def active(self, step: int) -> bool:
        hi = self.end_step if self.end_step is not None else 10**9
        return self.start_step <= step < hi

    def delay_at(self, step: int) -> float:
        """Injected delay at `step` (0 when inactive; ramped when drifting)."""
        if not self.active(step):
            return 0.0
        if self.ramp_steps <= 0:
            return self.delay_s
        frac = min(1.0, (step - self.start_step + 1) / self.ramp_steps)
        return self.delay_s * frac


@dataclasses.dataclass(frozen=True)
class Scenario:
    stages: tuple[str, ...]
    base_means: dict[str, float]     # seconds per stage
    sync_stages: tuple[str, ...]     # group barrier at end of these stages
    world_size: int
    steps: int
    jitter: float = 0.02             # lognormal sigma (relative)
    seed: int = 0
    faults: tuple[Fault, ...] = ()
    #: rank roles ("" = homogeneous); role groups sync independently.
    roles: tuple[str, ...] = ()
    #: physical placement (None = topology undeclared; the incident tier
    #: cannot correlate such a job's faults across the fleet by host).
    cluster: ClusterSpec | None = None

    def __post_init__(self):
        if (
            self.cluster is not None
            and self.cluster.world_size != self.world_size
        ):
            raise ValueError(
                f"cluster places {self.cluster.world_size} ranks but the "
                f"scenario runs {self.world_size}"
            )

    def schema(self) -> StageSchema:
        return StageSchema(
            stages=self.stages, world_size=self.world_size, roles=self.roles
        )

    @property
    def hosts(self) -> tuple[str, ...]:
        """Per-rank host names (() when the topology is undeclared)."""
        return self.cluster.hosts if self.cluster is not None else ()

    @property
    def switches(self) -> tuple[str, ...]:
        """Per-rank switch names (() when the fabric is undeclared)."""
        return self.cluster.switches if self.cluster is not None else ()

    @property
    def pods(self) -> tuple[str, ...]:
        """Per-rank pod names (() when the fabric is undeclared)."""
        return self.cluster.pods if self.cluster is not None else ()


@dataclasses.dataclass(frozen=True)
class SimResult:
    durations: np.ndarray            # [N, R, S] host-visible stage spans
    step_wall: np.ndarray            # [N, R]
    scenario: Scenario

    def seeded_stage_index(self) -> int:
        """Ordered-stage index of the (first) fault's seeded stage."""
        f = self.scenario.faults[0]
        return self.scenario.stages.index(f.stage)


def _role_groups(sc: Scenario) -> list[list[int]]:
    if not sc.roles:
        return [list(range(sc.world_size))]
    groups: dict[str, list[int]] = {}
    for r, role in enumerate(sc.roles):
        groups.setdefault(role, []).append(r)
    return list(groups.values())


def simulate(sc: Scenario) -> SimResult:
    rng = np.random.default_rng(sc.seed)
    n, r_count, s_count = sc.steps, sc.world_size, len(sc.stages)
    d = np.zeros((n, r_count, s_count))
    clock = np.zeros(r_count)                     # absolute host clock
    groups = _role_groups(sc)

    base = np.array([sc.base_means.get(s, 0.0) for s in sc.stages])

    for t in range(n):
        for si, stage in enumerate(sc.stages):
            work = base[si] * rng.lognormal(0.0, sc.jitter, size=r_count)
            comm_extra = 0.0
            for f in sc.faults:
                if not f.active(t):
                    continue
                amt = f.delay_at(t)
                if f.mode == "comm" and f.stage == stage:
                    comm_extra += amt           # slow collective: all wait
                elif f.stage == stage and f.mode == "host":
                    work[f.rank] += amt
                elif f.mode == "spillover":
                    if f.stage == stage:
                        work[f.rank] += amt * (1.0 - f.spill_frac)
                    if f.spill_to == stage:
                        work[f.rank] += amt * f.spill_frac
            arrival = clock + work
            if stage in sc.sync_stages:
                for g in groups:
                    t_release = arrival[g].max() + comm_extra
                    d[t, g, si] = t_release - clock[g]
                    arrival[g] = t_release
            else:
                d[t, :, si] = work
            clock = arrival
    wall = d.sum(axis=2)
    return SimResult(durations=d, step_wall=wall, scenario=sc)
