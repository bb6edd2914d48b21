"""Fleet aggregation service: ingest -> registry -> top-K profiler routing.

The serving loop of the always-on signal at fleet scale:

  1. `submit()` decodes one wire packet (failure-safe) and folds it into
     the job's streaming frontier state — incremental, no batch re-run;
  2. `refresh_batched()` stacks the jobs that shipped raw windows into one
     [J, N, R, S] tensor per shape group and runs the fused fleet kernel
     (jobs on the grid dimension): fleet-wide shares/gains/leaders in one
     pass instead of J dispatches;
  3. `route(k)` answers the operator question two steps past the paper —
     not just *where do I aim the heavy profiler* but *what is a fix
     worth, and is the fault still happening*: the top-K non-degraded
     jobs by estimated recoverable seconds (counterfactual what-if
     evidence) weighted by each candidate's temporal persistence
     (`core.regimes` — persistent > recurring > healed transient), each
     with the (stage, rank) candidate that yields that recovery and its
     regime classification.

Ticks are logical: callers advance `tick()` per aggregation round; jobs
silent for `evict_after` ticks are evicted (bounded state, dead jobs never
pin memory).

The tick kernels run on CUDA (`device="cuda"`, the default) or, for the
tests, as their plain torch versions on the CPU.  `fused=True` (the
default) refreshes each group with one launch of the fused tick kernel;
`fused=False` takes the four-dispatch reference route (a frontier and a
what-if launch per group), bit-identical by contract.  An attached
incident tier (`incidents.IncidentEngine`) runs its co-activation kernel
on its own `device`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Iterable

import numpy as np
import torch

from ..core.streaming import WindowStager
from ..kernels.frontier.fused import four_dispatch_tick, fused_fleet_tick
from ..obs import FleetObs
from ..telemetry.packets import EvidencePacket
from .ingest import FleetIngest
from .registry import FleetRegistry, JobState

if TYPE_CHECKING:  # pragma: no cover
    from ..incidents import IncidentEngine, Topology

__all__ = ["FleetService", "RouteEntry"]


@dataclasses.dataclass(frozen=True)
class RouteEntry:
    """One 'aim the profiler here' answer.

    `score` is the estimated recoverable seconds weighted by the fault's
    temporal persistence: routing ranks jobs by what a fix is worth *and
    whether the fault is still happening*.  `recoverable_s` keeps the raw
    counterfactual seconds; `persistence` is the [0, 1] regime weight
    (1.0 when the job has no temporal evidence — unknown is never
    deprioritized), `regime` the temporal class of the routed candidate
    ("" when unknown) and `onset_step` its job-global onset.  `urgency`
    carries the old evidence-weighted anomaly score for dashboards.
    """

    job_id: str
    stage: str
    rank: int
    score: float
    window_index: int
    labels: tuple[str, ...]
    recoverable_s: float = 0.0
    urgency: float = 0.0
    regime: str = ""
    persistence: float = 1.0
    onset_step: int = -1


class FleetService:
    #: routing-score floor of the persistence weight: a fully healed
    #: fault keeps this fraction of its recoverable-seconds score, so it
    #: ranks far below live faults but never silently vanishes from the
    #: answer (the operator can still see what it was worth).
    PERSISTENCE_FLOOR = 0.05

    def __init__(
        self,
        *,
        window_capacity: int = 100,
        evict_after: int = 10,
        degrade_after: int = 3,
        max_jobs: int = 100_000,
        regime_windows: int = 4,
        incidents: "IncidentEngine | None" = None,
        fused: bool = True,
        topology: "Topology | None" = None,
        device="cuda",
        obs: bool = True,
        obs_name: str = "service",
    ):
        #: torch device of the batched kernel refresh: "cuda" runs the
        #: hand-written tick kernels; "cpu" runs their plain torch
        #: versions (tests).  Never falls back from one to the other.
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FleetService(device='cuda'): no CUDA device is available "
                "(pass device='cpu' to run the plain tick on the CPU)"
            )
        self.ingest = FleetIngest()
        self.registry = FleetRegistry(
            window_capacity=window_capacity,
            evict_after=evict_after,
            degrade_after=degrade_after,
            max_jobs=max_jobs,
            regime_windows=regime_windows,
        )
        #: True routes `refresh_batched` through the fused tick kernel
        #: (one launch, one read of the stacked windows); False keeps the
        #: four-dispatch reference composition.  Flip to False when
        #: triaging a suspected kernel fault: the two routes are
        #: bit-identical by contract, so any divergence between them IS
        #: the bug report.
        self.fused = bool(fused)
        self._stager = WindowStager()
        #: optional incident tier (`incidents.IncidentEngine`): when
        #: attached, every `tick()` feeds it this round's route entries,
        #: evictions, and per-job activity series, and packets' declared
        #: host placements flow into its `Topology` — route answers gain
        #: identity, lifecycle, and common-cause grouping.
        self.incidents = incidents
        #: optional `incidents.Topology` to declare packet host
        #: placements into when this service runs as one shard of a
        #: sharded fleet whose coordinator owns the single engine.
        #: Ignored when `incidents` is attached (the engine's topology
        #: wins).
        self._topology = topology
        #: always-on self-observability (`obs`): the tick pipeline
        #: timed as an ordered stage vector (decode -> stage -> kernel ->
        #: epilog -> regimes -> correlate -> route), counters/histograms,
        #: and a flight-recorder ring — surfaced as `snapshot()["obs"]`.
        #: route()/snapshot() outputs are identical either way (the "obs"
        #: section aside).
        self.obs = FleetObs(name=obs_name) if obs else None
        self._tick = 0
        self.evicted_total = 0

    def _phase(self, name: str):
        """Tick-phase span (no-op context when obs is disabled)."""
        if self.obs is None:
            return contextlib.nullcontext()
        return self.obs.phase(name)

    # -- ingest ------------------------------------------------------------

    @property
    def current_tick(self) -> int:
        return self._tick

    def submit(
        self, job_id: str, data: bytes | EvidencePacket
    ) -> JobState | None:
        """Ingest one packet for `job_id`; returns the job state, or None
        if the payload was undecodable (counted, never raised)."""
        with self._phase("tick.decode"):
            pkt = self.ingest.decode(data)
        if self.obs is not None:
            self.obs.metrics.counter("packets").inc()
        if pkt is None:
            if self.obs is not None:
                self.obs.metrics.counter("decode_errors").inc()
            return None
        with self._phase("tick.regimes"):
            job = self.registry.update(job_id, pkt, self._tick)
        if job is not None:
            if self.obs is not None:
                self.obs.metrics.counter("packets_accepted").inc()
            self._declare_hosts(job_id, pkt)
        return job

    def _declare_hosts(self, job_id: str, pkt: EvidencePacket) -> None:
        """Land a packet's declared placement in the fleet topology —
        the attached engine's, or the coordinator engine's when this
        service is one shard of a sharded fleet.  SFP2-v3 packets also carry the
        fabric tiers (per-rank switch/pod ids); v2's host-only placement
        declares just the host tier, never erasing a prior fabric claim."""
        if not pkt.hosts:
            return
        if self.incidents is not None:
            self.incidents.topology.declare(
                job_id, pkt.hosts, switches=pkt.switches, pods=pkt.pods
            )
        elif self._topology is not None:
            self._topology.declare(
                job_id, pkt.hosts, switches=pkt.switches, pods=pkt.pods
            )

    def submit_many(
        self,
        items: Iterable[tuple[str, bytes | EvidencePacket]],
        *,
        refresh: bool = False,
    ) -> int:
        """Ingest one tick's batch of `(job_id, wire)` pairs; returns how
        many were accepted (decoded AND folded — a full registry refusing
        a new job id does not count).

        This is the amortized tick path: the whole batch decodes through
        `FleetIngest.decode_many` before any registry fold, and with
        `refresh=True` the accepted raw windows go straight into one
        `refresh_batched()` kernel pass — wire bytes to fleet-wide
        shares/what-if matrices with no intermediate window copies
        (SFP2 float64 payloads stay zero-copy views until the registry's
        single float32 cast).
        """
        pairs = list(items)
        with self._phase("tick.decode"):
            pkts = self.ingest.decode_many(data for _, data in pairs)
        accepted = 0
        with self._phase("tick.regimes"):
            for (job_id, _), pkt in zip(pairs, pkts):
                if pkt is None:
                    continue
                if self.registry.update(job_id, pkt, self._tick) is not None:
                    accepted += 1
                    self._declare_hosts(job_id, pkt)
        if self.obs is not None:
            m = self.obs.metrics
            m.counter("packets").inc(len(pairs))
            m.counter("packets_accepted").inc(accepted)
            m.counter("decode_errors").inc(
                sum(1 for p in pkts if p is None)
            )
        if refresh:
            self.refresh_batched()
        return accepted

    def tick(self) -> list[str]:
        """Advance the logical clock; evicts and returns stale job ids.

        With an incident engine attached, the tick also folds this
        round's full route answer (every routable job), the evictions,
        and the per-job regime activity series into the engine — the
        stateless per-window answer becomes durable incidents.
        """
        self._tick += 1
        with self._phase("tick.regimes"):
            evicted = self.registry.evict_stale(self._tick)
            self.evicted_total += len(evicted)
            activity = None
            if self.incidents is not None:
                activity = {
                    job.job_id: (job.regimes.activity(), job.stages)
                    for job in self.registry.jobs()
                    if job.regimes is not None and job.regimes.num_steps
                }
        if self.incidents is not None:
            routes = self.route(len(self.registry))
            with self._phase("tick.correlate"):
                self.incidents.observe(
                    self._tick,
                    routes,
                    evicted=evicted,
                    activity=activity,
                )
        if self.obs is not None:
            self.obs.on_tick(
                self._tick,
                evicted=len(evicted),
                live=len(self.registry),
            )
        return evicted

    # -- batched kernel refresh --------------------------------------------

    def refresh_batched(
        self, *, min_jobs: int = 1, fused: bool | None = None
    ) -> int:
        """Re-account every *dirty* window-carrying job through the fleet
        tick kernel, grouped by window shape.  Returns jobs refreshed.

        Dirty = a new raw window arrived since the last refresh (the
        registry nulls `kernel_shares` on ingest), so per-tick cost scales
        with updated jobs, not fleet size.  Every dirty group refreshes by
        default — routing quality depends on the what-if matrix, and a
        skipped group would also keep its raw windows pinned; callers that
        prefer leaving tiny groups to their streaming state can raise
        `min_jobs`.

        Each refresh runs the frontier accounting AND the batched
        counterfactual route on the same stacked tensor, so every
        refreshed job carries a dense [S, R] recoverable-time matrix —
        the evidence `route(k)` ranks by.  With `fused` (default: the
        service flag) both come out of ONE `fused_fleet_tick` kernel
        launch that reads the window tensor once; `fused=False` takes the
        four-dispatch reference composition (`four_dispatch_tick`),
        bit-identical by contract.  The counterfactual replays each job's
        *declared* sync profile (packet `sync_stages`), so jobs are
        grouped by (window shape, sync profile): one launch per group and
        family.  The reference package's buffer donation has no
        counterpart: the device copy of the staged windows is an ordinary
        tensor, freed after the launch.
        """
        tick_route = (
            fused_fleet_tick
            if (self.fused if fused is None else bool(fused))
            else four_dispatch_tick
        )
        refreshed = groups = 0
        for (shape, sync_idx), jobs in sorted(
            self.registry.dirty_groups().items()
        ):
            if len(jobs) < min_jobs:
                continue
            # Stage into the recycled host buffer: the job dimension is
            # padded to the next power of two (replicating the last job's
            # window), so elastic fleets reuse a bounded set of buffer and
            # tensor shapes.  Per-job accounting is independent across
            # jobs, so the first-J outputs are unchanged; the padded rows
            # are sliced away below.
            j_live = len(jobs)
            groups += 1
            with self._phase("tick.stage"):
                staged = self._stager.stage([j.last_window for j in jobs])
                # a copy on CUDA (pageable source: the copy is complete
                # when it returns, so the recycled buffer is free again);
                # on the CPU a view of the buffer, consumed right below
                stacked = torch.from_numpy(staged).to(self.device)
            with self._phase("tick.kernel"):
                tick = tick_route(
                    stacked, sync_stages=sync_idx, with_regimes=False,
                )
                if self.device.type == "cuda":
                    # the launches are asynchronous: wait here, or the
                    # kernels' time is charged to tick.epilog.  Only for
                    # this thread's stream: a sharded service's other
                    # shards launch on streams of their own
                    torch.cuda.current_stream(self.device).synchronize()
            with self._phase("tick.epilog"):
                pkt, wif = tick.frontier, tick.whatif
                shares = pkt.shares[:j_live].cpu().numpy()     # [J, S]
                gains = pkt.gains[:j_live].cpu().numpy()       # [J, S]
                leader = pkt.leader[:j_live].cpu().numpy()     # [J, N, S]
                whatif = wif.matrix[:j_live].cpu().numpy()     # [J, S, R]
                for i, job in enumerate(jobs):
                    job.kernel_shares = shares[i]
                    job.kernel_gains = gains[i]
                    top = int(np.argmax(shares[i]))
                    # mode of the per-step leader at the top boundary
                    ranks, counts = np.unique(
                        leader[i, :, top], return_counts=True
                    )
                    job.kernel_leader = int(ranks[np.argmax(counts)])
                    job.whatif = whatif[i]
                    # raw window consumed: release it (bounded registry)
                    job.last_window = None
                    refreshed += 1
        if self.obs is not None and refreshed:
            self.obs.metrics.counter("jobs_refreshed").inc(refreshed)
            # one tick-route call (one fused launch) per group
            self.obs.metrics.counter("groups_refreshed").inc(groups)
        return refreshed

    # -- routing -----------------------------------------------------------

    def route(self, k: int = 10) -> list[RouteEntry]:
        """Top-K jobs by persistence-weighted recoverable seconds.

        The ranking answers "where is a fix worth the most step time —
        and is the fault still happening": each job's raw score is its
        best counterfactual (the argmax cell of the kernel-refreshed
        what-if matrix when fresh, else the packet's whole-stage clipped
        gain converted to seconds — see `JobState.recoverable`),
        multiplied by the candidate's temporal persistence weight
        (`core.regimes`): a persistent fault keeps ~its full price, an
        intermittent its duty cycle, a healed blip decays toward the
        `PERSISTENCE_FLOOR`.  Jobs with no temporal evidence (compact
        packets) keep weight 1.0 — unknown is never deprioritized.  The
        reported (stage, rank) is that same candidate — one evidence
        source per answer, never a stage from one window paired with
        another's rank.

        Ordering is fully deterministic: weighted seconds descending,
        ties broken by job id ascending, then by rank index ascending
        (stable across dict insertion order and refresh timing; the
        third key guards the day an answer carries several rank
        candidates per job — two entries tying on (score, job_id) must
        still order identically on every run).  Degraded
        (telemetry_limited) jobs never appear: quality labels must not
        trigger workload-touching actions.
        """
        with self._phase("tick.route"):
            floor = self.PERSISTENCE_FLOOR
            scored = []
            for job in self.registry.jobs():
                rec, si, ri = job.recoverable()
                if rec <= 0.0:
                    continue
                w = job.persistence(si, ri)
                call = job.regime_call(si, ri)
                score = (
                    rec if w is None
                    else rec * (floor + (1.0 - floor) * w)
                )
                scored.append((score, rec, si, ri, w, call, job))
            scored.sort(key=lambda t: (-t[0], t[6].job_id, t[3]))
            out: list[RouteEntry] = []
            for score, rec, si, ri, w, call, job in scored[: max(0, k)]:
                pkt = job.last_packet
                stage = job.stages[si] if 0 <= si < len(job.stages) else ""
                out.append(
                    RouteEntry(
                        job_id=job.job_id,
                        stage=stage,
                        rank=ri,
                        score=score,
                        window_index=pkt.window_index if pkt else -1,
                        labels=job.labels,
                        recoverable_s=rec,
                        urgency=job.urgency(),
                        regime=call.name if call is not None else "",
                        persistence=1.0 if w is None else w,
                        onset_step=call.onset if call is not None else -1,
                    )
                )
        if self.obs is not None:
            self.obs.on_route(self._tick, out)
        return out

    # -- summaries ---------------------------------------------------------

    def snapshot(self) -> dict:
        jobs = self.registry.jobs()
        regimes: dict[str, int] = {}
        for j in jobs:
            for name, c in j.regime_counts().items():
                if name != "none":
                    regimes[name] = regimes.get(name, 0) + c
        out = {
            "tick": self._tick,
            "jobs": len(jobs),
            "degraded_jobs": sum(1 for j in jobs if j.degraded),
            # live fault candidates per temporal class, fleet-wide
            "regimes": regimes,
            "evicted_total": self.evicted_total,
            "rejected_total": self.registry.rejected_total,
            "duplicate_total": self.registry.duplicate_total,
            "packets": self.ingest.stats.packets,
            "bytes": self.ingest.stats.bytes,
            "decode_errors": self.ingest.stats.decode_errors,
            "predecoded": self.ingest.stats.predecoded,
            "avg_wire_bytes": self.ingest.stats.avg_wire_bytes,
            # lifetime counter (registry-owned): monotonic even across
            # eviction — summing live jobs made this run backwards.
            "windows_seen": self.registry.windows_total,
        }
        if self.incidents is not None:
            # live incidents per lifecycle state (+ lifetime resolved)
            out["incidents"] = self.incidents.counts()
            # conflicting-claim re-homings (last-writer-wins topology
            # churn) — operators watch this to catch placement drift.
            out["rehomed"] = self.incidents.topology.rehomed
        if self.obs is not None:
            # self-observability section (docs/observability.md) — the
            # only snapshot key carrying wall-clock state; parity
            # comparisons strip it (obs-on == obs-off elsewhere, gated
            # by benchmarks/obs_overhead.py).
            out["obs"] = self.obs.section()
        return out
