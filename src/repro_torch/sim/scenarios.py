"""Canonical scenario builders mirroring the paper's experiment groups.

The DDP profile uses the paper's six broad stages with backward carrying the
gradient collective (reducer activity and exposed collective waits land in
the backward stage, §5).  Magnitudes roughly track the paper's 8-rank runs
(~208 ms median step, E6).

Fault families (E3) and the counterfactual ground truth each yields
---------------------------------------------------------------------
Because the simulator injects delay explicitly, every scenario knows — by
construction — what a perfect fix would recover, which is what validates
the what-if engine (`repro.core.whatif`).  `injected_recoverable(sc)`
returns that ground truth per (stage, rank) candidate.

``data``           host-mode delay in ``data.next_wait`` on one hidden
                   rank.  Rank-attributable: the delay is host-visible on
                   the faulted rank *before* the barrier, so the what-if
                   candidate (data.next_wait, rank) recovers ~delay x
                   active steps (the sync replay removes the group wait
                   the delay would have displaced downstream).
``backward``       host-mode delay inside ``model.backward_cpu_wall`` —
                   the DDP sync stage itself.  A perfect fix recovers
                   delay x steps (that is the oracle ground truth), but
                   from coarse stage durations the fault is
                   *group-ambiguous*: the release shifts for every rank,
                   so the observed rows are indistinguishable from a slow
                   collective.  An honest engine reports ~0 for every
                   single-rank candidate here and flags
                   ``sync_stage_ambiguous`` — see
                   `attributable_recoverable`.
``backward_comm``  the collective itself is slow: the release time of the
                   backward sync shifts for EVERY rank.  Deliberately NOT
                   rank-attributable — no single-rank counterfactual
                   recovers it, and the work imputation absorbs it (all
                   ranks inflate together), so the correct what-if answer
                   is ~0 with the candidate flagged ``group_wide`` /
                   ``sync_stage_ambiguous``.  `injected_recoverable`
                   therefore excludes it.
``forward_device`` device work launched in forward becomes host-visible in
                   backward (spillover, ``spill_frac=0.8``): the ground
                   truth splits — ~20% of delay x steps at
                   (fwd_loss, rank), ~80% at (backward, rank).  Under DDP
                   only the fwd_loss piece is observed at a non-sync
                   stage, so only it is attributable from stage spans;
                   the backward piece is sync-stage-ambiguous (above).
``forward_host``   host-mode delay in ``model.fwd_loss_cpu_wall``;
                   rank-attributable at (fwd_loss, rank) under DDP and
                   ZeRO-1 (non-sync there) — under FSDP fwd_loss is a
                   barrier stage and the same ambiguity applies.

Sync profiles: **DDP** barriers at backward, **FSDP** at forward and
backward, **ZeRO-1** at backward and optimizer step — a fault surfaces as
wait at whichever profile boundary first follows it.  The oracle
ground-truth recoverable time is profile-independent (the delay is the
delay), but *which of it is attributable from coarse durations* depends
on the profile: exactly the candidates observed at non-sync stages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.contract import SEGMENTED_STAGES
from .cluster import ClusterSpec, Fault, Scenario

#: base per-stage means (seconds) — ~208 ms step like the paper's E6 runs.
DDP_BASE = {
    "data.next_wait": 0.012,
    "model.fwd_loss_cpu_wall": 0.055,
    "model.backward_cpu_wall": 0.105,
    "callbacks.cpu_wall": 0.012,
    "optim.step_cpu_wall": 0.022,
    "step.other_cpu_wall": 0.002,
}

DDP_SYNC = ("model.backward_cpu_wall",)                 # DDP allreduce
FSDP_SYNC = (
    "model.fwd_loss_cpu_wall",                          # all-gather
    "model.backward_cpu_wall",                          # reduce-scatter
)
ZERO1_SYNC = (
    "model.backward_cpu_wall",
    "optim.step_cpu_wall",                              # shard all-gather
)

#: E3 hidden-rank fault families -> fault constructor.
E3_FAMILIES = ("data", "backward", "backward_comm", "forward_device", "forward_host")


def injected_recoverable(sc: Scenario) -> dict[tuple[str, int], float]:
    """Ground-truth recoverable seconds per (stage, rank) candidate.

    Known by construction: each *rank-attributable* fault contributes
    ``delay_s x active_steps`` at the stage where the host observes it
    (spillover faults split ``spill_frac`` of it into their target
    stage).  ``comm``-mode faults are group-wide — no single-rank
    intervention removes them — so they are deliberately absent; a
    correct what-if engine reports ~0 for them.

    This is the *oracle*: what a perfect intervention recovers, including
    delay injected inside a sync stage that no coarse-duration engine can
    rank-attribute (see `attributable_recoverable` for the subset an
    honest engine can price).  `tests/test_whatif.py` and
    `benchmarks/whatif_matrix.py` score the engine against the
    attributable subset (acceptance: top-1 recovers >= 90%).
    """
    out: dict[tuple[str, int], float] = {}

    def _add(stage: str, rank: int, seconds: float) -> None:
        key = (stage, rank)
        out[key] = out.get(key, 0.0) + seconds

    for f in sc.faults:
        hi = sc.steps if f.end_step is None else min(f.end_step, sc.steps)
        if hi <= f.start_step:
            continue
        # exact under ramped (drift) onsets too: sum the per-step delay
        total = sum(f.delay_at(t) for t in range(f.start_step, hi))
        if total <= 0.0:
            continue
        if f.mode == "host":
            _add(f.stage, f.rank, total)
        elif f.mode == "spillover":
            _add(f.stage, f.rank, total * (1.0 - f.spill_frac))
            _add(f.spill_to, f.rank, total * f.spill_frac)
    return out


def attributable_recoverable(sc: Scenario) -> dict[tuple[str, int], float]:
    """The subset of `injected_recoverable` observable at non-sync stages.

    Delay that first becomes host-visible *inside* a barrier-bearing stage
    shifts the release for the whole group: every rank's observed span
    inflates identically (up to jitter), so the faulted rank is
    information-theoretically hidden from coarse stage durations — a host
    fault there and a slow collective produce the same rows.  The what-if
    engine marks such candidates ``sync_stage_ambiguous`` and prices them
    ~0 rather than guessing; this helper returns the candidates it CAN
    price, which is what the >= 90% top-1 validation runs against.
    """
    return {
        (stage, rank): v
        for (stage, rank), v in injected_recoverable(sc).items()
        if stage not in sc.sync_stages
    }


def e3_fault(family: str, rank: int, delay_s: float) -> Fault:
    if family == "data":
        return Fault(rank, "data.next_wait", delay_s)
    if family == "backward":
        return Fault(rank, "model.backward_cpu_wall", delay_s)
    if family == "backward_comm":
        return Fault(rank, "model.backward_cpu_wall", delay_s, mode="comm")
    if family == "forward_device":
        return Fault(
            rank,
            "model.fwd_loss_cpu_wall",
            delay_s,
            mode="spillover",
            spill_to="model.backward_cpu_wall",
            spill_frac=0.8,
        )
    if family == "forward_host":
        return Fault(rank, "model.fwd_loss_cpu_wall", delay_s)
    raise ValueError(f"unknown E3 family {family!r}")


def ddp_scenario(
    *,
    world_size: int = 8,
    steps: int = 120,
    seed: int = 0,
    faults: tuple[Fault, ...] = (),
    sync=DDP_SYNC,
    roles: tuple[str, ...] = (),
    base: dict | None = None,
    cluster: ClusterSpec | None = None,
) -> Scenario:
    return Scenario(
        stages=SEGMENTED_STAGES,
        base_means=dict(base or DDP_BASE),
        sync_stages=tuple(sync),
        world_size=world_size,
        steps=steps,
        seed=seed,
        faults=faults,
        roles=roles,
        cluster=cluster,
    )


def hidden_fault_rank(seed: int, world_size: int = 8) -> int:
    """The seed-derived faulted rank of `hidden_rank_scenario` /
    `callback_scenario` — the ONE definition (like `regime_fault_rank`),
    so drivers placing that rank on a topology (serve_fleet
    ``--topology shared``) cannot drift from the injection."""
    return (seed * 7 + 3) % world_size


def hidden_rank_scenario(
    family: str,
    *,
    world_size: int = 8,
    steps: int = 120,
    seed: int = 0,
    delay_ms: float = 120.0,
    sync=DDP_SYNC,
) -> Scenario:
    """One E3 row: the faulted rank is derived from the seed (hidden)."""
    rank = hidden_fault_rank(seed, world_size)
    return ddp_scenario(
        world_size=world_size,
        steps=steps,
        seed=seed,
        faults=(e3_fault(family, rank, delay_ms / 1e3),),
        sync=sync,
    )


def callback_scenario(
    *,
    sync_bearing: bool,
    world_size: int = 8,
    steps: int = 120,
    seed: int = 0,
    delay_ms: float = 120.0,
) -> Scenario:
    """Callback study: sync-bearing rows barrier at the callback boundary;
    the host-only control has no adjacent barrier (the cost displaces into
    the next step's backward sync and must stay unrouted)."""
    rank = hidden_fault_rank(seed, world_size)
    sync = DDP_SYNC + (("callbacks.cpu_wall",) if sync_bearing else ())
    return ddp_scenario(
        world_size=world_size,
        steps=steps,
        seed=seed,
        faults=(Fault(rank, "callbacks.cpu_wall", delay_ms / 1e3),),
        sync=sync,
    )


# ---------------------------------------------------------------------------
# Temporal regime fault families (ground truth for repro.core.regimes)
# ---------------------------------------------------------------------------
#
# Each family injects a known *activity pattern* over time, so the regime
# engine's transient/recurring/persistent classification can be scored
# against a by-construction label.  All families seed a non-sync stage
# (data.next_wait): delay inside a barrier stage is group-ambiguous from
# coarse durations (see `attributable_recoverable`), so temporal
# classification there would be classifying the imputation, not the fault.

#: regime family -> ground-truth classification label name.
REGIME_FAMILIES = {
    "blip": "transient",          # one early burst, self-healing
    "intermittent": "recurring",  # periodic short data stalls
    "step": "persistent",         # step-function degradation, never heals
    "drift": "persistent",        # slow thermal-throttle ramp, never heals
}


def regime_faults(
    family: str, rank: int, delay_s: float, steps: int
) -> tuple[Fault, ...]:
    """Fault tuple realizing one temporal family over a `steps`-long run.

    blip:         active [steps/6, steps/6 + max(3, steps/10)) then gone;
    intermittent: 4-step bursts every 12 steps from steps/6 on (bursts are
                  shorter than the default `persistent_streak`, so a live
                  burst never promotes to persistent);
    step:         active [steps/2, end);
    drift:        active [steps/4, end) with the delay ramping linearly to
                  `delay_s` over steps/2 active steps (positive trend
                  slope by construction).
    """
    stage = "data.next_wait"
    if family == "blip":
        lo = steps // 6
        return (Fault(rank, stage, delay_s, start_step=lo,
                      end_step=lo + max(3, steps // 10)),)
    if family == "intermittent":
        return tuple(
            Fault(rank, stage, delay_s, start_step=t0,
                  end_step=min(t0 + 4, steps))
            for t0 in range(steps // 6, steps, 12)
        )
    if family == "step":
        return (Fault(rank, stage, delay_s, start_step=steps // 2),)
    if family == "drift":
        return (Fault(rank, stage, delay_s, start_step=steps // 4,
                      ramp_steps=max(1, steps // 2)),)
    raise ValueError(f"unknown regime family {family!r}")


def regime_fault_rank(seed: int, world_size: int = 8) -> int:
    """The seed-derived faulted rank of `regime_scenario` — the ONE
    definition, so benchmarks/tests reading the ground-truth candidate
    cannot drift from the injection."""
    return (seed * 5 + 2) % world_size


def regime_scenario(
    family: str,
    *,
    world_size: int = 8,
    steps: int = 60,
    seed: int = 0,
    delay_ms: float = 120.0,
    sync=DDP_SYNC,
    cluster: ClusterSpec | None = None,
) -> Scenario:
    """One labelled temporal-regime row; the faulted rank is seed-derived
    (`regime_fault_rank`).

    Ground truth: the regime engine should classify the candidate
    ``("data.next_wait", injected rank)`` as ``REGIME_FAMILIES[family]``
    once the window covers the pattern (and as `none` on every healthy
    control candidate).  `cluster` declares the physical placement
    explicitly (the incident tier correlates by host; topology must never
    be implied by scenario code)."""
    rank = regime_fault_rank(seed, world_size)
    return ddp_scenario(
        world_size=world_size,
        steps=steps,
        seed=seed,
        faults=regime_faults(family, rank, delay_ms / 1e3, steps),
        sync=sync,
        cluster=cluster,
    )


def injected_activity(sc: Scenario, stage: str, rank: int) -> np.ndarray:
    """Ground-truth per-step injected-delay series for one candidate. [N]

    The regime engine's activity series should match this (thresholded)
    wherever the injected delay clears the detection threshold."""
    out = np.zeros(sc.steps)
    for f in sc.faults:
        if f.rank != rank:
            continue
        for t in range(sc.steps):
            amt = f.delay_at(t)
            if f.mode == "spillover":
                if f.stage == stage:
                    out[t] += amt * (1.0 - f.spill_frac)
                if f.spill_to == stage:
                    out[t] += amt * f.spill_frac
            elif f.stage == stage:
                out[t] += amt
    return out


# ---------------------------------------------------------------------------
# Multi-job shared-host fault families (ground truth for repro.incidents)
# ---------------------------------------------------------------------------
#
# The incident tier's common-cause question — "is this the SAME fault,
# seen through several jobs?" — needs fleets where a physical host is
# shared across jobs and a host-level fault surfaces in each of them.
# `shared_host_fleet` builds such a fleet with the topology declared
# explicitly (`ClusterSpec`) and the common cause known by construction.

@dataclasses.dataclass(frozen=True)
class SharedHostFleet:
    """One labelled multi-job common-cause row.

    `scenarios` maps job id -> Scenario (each carrying its own
    `ClusterSpec`); ground truth: every job in `shared_job_ids` hosts one
    rank on `shared_host`, and that host's fault (temporal family
    `family`) is the one common cause the incident engine must promote —
    exactly one fleet-level incident, on `shared_host`, merging the
    sharing jobs' single-job incidents.  Distractor jobs carry an
    unrelated self-healing blip on a private host (never shared, so
    correlation must NOT promote it).
    """

    scenarios: dict[str, Scenario]
    shared_host: str
    shared_job_ids: tuple[str, ...]
    family: str
    #: job id -> the rank that sits on the faulted/distractor host
    fault_ranks: dict[str, int]


def shared_host_fleet(
    *,
    jobs: int = 6,
    shared_jobs: int = 3,
    world_size: int = 8,
    ranks_per_host: int = 2,
    steps: int = 60,
    seed: int = 0,
    delay_ms: float = 150.0,
    family: str = "step",
    distractor_family: str | None = "blip",
    sync=DDP_SYNC,
    shard_split: int | None = None,
) -> SharedHostFleet:
    """Simulated fleet where `shared_jobs` of `jobs` share one faulted host.

    Each job packs `ranks_per_host` ranks per private host
    (`ClusterSpec.uniform`), except that in the first `shared_jobs` jobs a
    seed-derived rank is re-homed onto the fleet-shared host
    ``shared-{seed}`` — and that rank carries the injected temporal fault
    (`REGIME_FAMILIES[family]`; the default ``step`` stays live, so the
    incident must be active, not healed).  Non-sharing jobs optionally
    carry a `distractor_family` blip on a private host: a correlator that
    merely clusters "any fault anywhere" would wrongly promote it.

    `shard_split=N` derives each job's id with
    `fleet.shard.job_id_for_shard` so job j hashes to shard ``j % N`` of
    an N-shard `ShardedFleetService` — with ``N >= shared_jobs`` every
    host-sharing job is GUARANTEED to live on a different shard, the
    placement that forces common-cause promotion through the cross-shard
    activity reduce (no lucky co-location).
    """
    if not 0 <= shared_jobs <= jobs:
        raise ValueError(f"shared_jobs={shared_jobs} outside [0, {jobs}]")
    if shard_split is not None:
        # lazy: sim stays importable without the fleet tier loaded
        from ..fleet.shard import job_id_for_shard
    shared_host = f"shared-{seed}"
    scenarios: dict[str, Scenario] = {}
    shared_ids: list[str] = []
    fault_ranks: dict[str, int] = {}
    for j in range(jobs):
        job_id = f"job-{j:03d}"
        if shard_split is not None:
            job_id = job_id_for_shard(job_id, j % shard_split, shard_split)
        rank = regime_fault_rank(seed + j, world_size)
        hosts = list(
            ClusterSpec.uniform(
                world_size, ranks_per_host, prefix=f"h{j}"
            ).hosts
        )
        faults: tuple[Fault, ...] = ()
        if j < shared_jobs:
            hosts[rank] = shared_host
            faults = regime_faults(family, rank, delay_ms / 1e3, steps)
            shared_ids.append(job_id)
            fault_ranks[job_id] = rank
        elif distractor_family is not None:
            faults = regime_faults(
                distractor_family, rank, delay_ms / 1e3, steps
            )
            fault_ranks[job_id] = rank
        scenarios[job_id] = ddp_scenario(
            world_size=world_size,
            steps=steps,
            seed=seed * 1000 + j,
            faults=faults,
            sync=sync,
            cluster=ClusterSpec(world_size=world_size, hosts=tuple(hosts)),
        )
    return SharedHostFleet(
        scenarios=scenarios,
        shared_host=shared_host,
        shared_job_ids=tuple(shared_ids),
        family=family,
        fault_ranks=fault_ranks,
    )


# ---------------------------------------------------------------------------
# Multi-job FABRIC fault families (ground truth for tier attribution)
# ---------------------------------------------------------------------------
#
# "When Scaling Fails" attributes many production slowdowns to the fabric
# tiers ABOVE the host: an oversubscribed uplink degrades every host
# under one switch, a flapping switch does so intermittently, pod-wide
# congestion degrades hosts under every switch of one pod.  Each family
# here realizes one such fault with the affected jobs' placements
# declared per rank (`ClusterSpec` switches/pods — the SFP2-v3 layout)
# and the ground-truth (tier, node) known by construction, so the
# incident engine's narrowest-tier promotion can be scored: the fleet
# incident must land on exactly that tier and node — never on three
# separate host incidents, never on a wider tier than the evidence
# needs.

#: fabric family -> (ground-truth attribution tier, temporal family of
#: the injected fault).  `shared_host` is the control: fabric declared,
#: but the narrowest explaining tier is still the host.
FABRIC_FAMILIES = {
    "shared_host": ("host", "step"),
    "oversub_uplink": ("switch", "step"),
    "flapping_switch": ("switch", "intermittent"),
    "pod_congestion": ("pod", "step"),
}


@dataclasses.dataclass(frozen=True)
class FabricFleet:
    """One labelled multi-job fabric-attribution row.

    `scenarios` maps job id -> Scenario (each carrying a tiered
    `ClusterSpec`); ground truth: every job in `member_job_ids` has one
    faulted rank under the fabric node `node` at tier `tier`, and the
    incident engine must promote exactly ONE fleet incident there —
    `tier` is the narrowest tier explaining the co-activation (for
    ``oversub_uplink``, the faulted hosts are distinct, so no host-tier
    candidate reaches quorum and the switch is the answer).  Distractor
    jobs carry an unrelated self-healing blip on private fabric.
    """

    scenarios: dict[str, Scenario]
    tier: str
    node: str
    member_job_ids: tuple[str, ...]
    family: str                       # fabric family name
    regime_family: str                # temporal family of the fault
    #: job id -> the rank that sits under the faulted node
    fault_ranks: dict[str, int]


def fabric_fleet(
    family: str = "oversub_uplink",
    *,
    jobs: int = 6,
    shared_jobs: int = 3,
    world_size: int = 8,
    ranks_per_host: int = 2,
    steps: int = 60,
    seed: int = 0,
    delay_ms: float = 150.0,
    distractor_family: str | None = "blip",
    sync=DDP_SYNC,
    shard_split: int | None = None,
) -> FabricFleet:
    """Simulated fleet with one fabric fault of `family` affecting the
    first `shared_jobs` jobs.

    Placement of the faulted rank (seed-derived, `regime_fault_rank`)
    per family — the NODE is shared, everything narrower is private:

      shared_host     all affected ranks on ONE host (under one switch/
                      pod) -> the host is the narrowest explaining tier;
      oversub_uplink  each affected rank on its OWN host, all hosts
                      under ONE switch -> no host reaches quorum, the
                      switch does (persistent ``step`` fault);
      flapping_switch same placement, ``intermittent`` fault — the
                      bursts co-activate across jobs in the same steps;
      pod_congestion  own host AND own switch per job, all switches
                      under ONE pod -> only the pod reaches quorum.

    Every other rank lives on private fabric (`uniform` hosts, one
    switch+pod per private host), so nothing outside the seeded node can
    promote.  `shard_split` works as in `shared_host_fleet`: with
    ``N >= shared_jobs`` every affected job lands on a different shard,
    forcing tier promotion through the cross-shard reduce.
    """
    if family not in FABRIC_FAMILIES:
        raise ValueError(
            f"unknown fabric family {family!r}: {sorted(FABRIC_FAMILIES)}"
        )
    if not 0 <= shared_jobs <= jobs:
        raise ValueError(f"shared_jobs={shared_jobs} outside [0, {jobs}]")
    if shard_split is not None:
        from ..fleet.shard import job_id_for_shard
    tier, regime_family = FABRIC_FAMILIES[family]
    fab_host = f"fab-host-{seed}"
    fab_sw = f"fab-sw-{seed}"
    fab_pod = f"fab-pod-{seed}"
    node = {"host": fab_host, "switch": fab_sw, "pod": fab_pod}[tier]
    scenarios: dict[str, Scenario] = {}
    member_ids: list[str] = []
    fault_ranks: dict[str, int] = {}
    for j in range(jobs):
        job_id = f"job-{j:03d}"
        if shard_split is not None:
            job_id = job_id_for_shard(job_id, j % shard_split, shard_split)
        rank = regime_fault_rank(seed + j, world_size)
        hosts = list(
            ClusterSpec.uniform(
                world_size, ranks_per_host, prefix=f"h{j}"
            ).hosts
        )
        faults: tuple[Fault, ...] = ()
        if j < shared_jobs:
            if tier == "host":
                hosts[rank] = fab_host
            else:
                hosts[rank] = f"fab-h{j}-{seed}"
            faults = regime_faults(
                regime_family, rank, delay_ms / 1e3, steps
            )
            member_ids.append(job_id)
            fault_ranks[job_id] = rank
        elif distractor_family is not None:
            faults = regime_faults(
                distractor_family, rank, delay_ms / 1e3, steps
            )
            fault_ranks[job_id] = rank
        # private fabric everywhere, then the shared node over the
        # faulted rank's placement
        switches = [f"{h}.sw" for h in hosts]
        pods = [f"{h}.pod" for h in hosts]
        if j < shared_jobs:
            switches[rank] = (
                fab_sw if tier in ("host", "switch") else f"fab-swj{j}-{seed}"
            )
            pods[rank] = fab_pod
        scenarios[job_id] = ddp_scenario(
            world_size=world_size,
            steps=steps,
            seed=seed * 1000 + j,
            faults=faults,
            sync=sync,
            cluster=ClusterSpec(
                world_size=world_size,
                hosts=tuple(hosts),
                switches=tuple(switches),
                pods=tuple(pods),
            ),
        )
    return FabricFleet(
        scenarios=scenarios,
        tier=tier,
        node=node,
        member_job_ids=tuple(member_ids),
        family=family,
        regime_family=regime_family,
        fault_ranks=fault_ranks,
    )


def aba_windows(
    *, world_size: int = 8, steps: int = 200, seed: int = 0, delay_ms: float = 120.0
):
    """E6: baseline A1, injected B (sync-bearing callback), removed A2."""
    a1 = ddp_scenario(world_size=world_size, steps=steps, seed=seed)
    b = callback_scenario(
        sync_bearing=True,
        world_size=world_size,
        steps=steps,
        seed=seed + 1000,
        delay_ms=delay_ms,
    )
    a2 = ddp_scenario(world_size=world_size, steps=steps, seed=seed + 2000)
    return a1, b, a2
