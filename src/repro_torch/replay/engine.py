"""Trace-driven replay: cluster-shaped job records -> fleet validation.

`replay_trace` advances a logical clock over a loaded `Trace` one tick
(= one evidence window) at a time.  Each tick it applies the trace's
arrival/resize/departure/fault events, simulates exactly one window of
host-visible stage durations per live job (the discrete-event simulator
with the trace's injected faults mapped into window-local coordinates),
runs each window through the standard `WindowAggregator`, packetizes and
wire-encodes the evidence, and drives the whole batch through a
`FleetService` — the same submit_many / tick / route path as
`launch.serve_fleet`, but with the elastic, role-heterogeneous workload
a real cluster trace implies: jobs with different stage vocabularies in
one ingest, parameter-server vs. worker asymmetry, registry eviction on
departure, schema-break stream restarts on resize and re-arrival.

Validation closes the loop: because every trace fault declares its
family, rank, and delay, the replay knows per window which (job, stage,
rank) candidates are *rank-attributable* ground truth (host-observable
delay at a non-barrier stage — the same observability rule as
`sim.scenarios.attributable_recoverable`) and scores the service's top-K
routing answer against them.  Group-ambiguous injections (the
"backward_comm" control family, or anything below the scoring floor)
are counted but never scored — expecting the router to name a rank for
a slow collective would be scoring a guess.

The result is a machine-readable `ReplayReport`: replay volume, churn
counters (arrivals / re-arrivals / resizes / departures / evictions),
routing accuracy per fault family, loader skip statistics, and the
final service snapshot.

The service's tick kernels (and the incident tier's co-activation
kernel) run on `device`: CUDA by default, or their plain torch versions
with ``device="cpu"``; `shards` replays through a `ShardedFleetService`
on the same device, one CUDA stream per shard.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING

from ..core import WindowAggregator
from ..fleet import FleetService
from ..sim import Fault, Scenario, simulate
from ..telemetry.packets import encode_packet, from_diagnosis
from .trace import (
    SCORED_FAMILIES,
    STAGE_MEANS,
    Trace,
    TraceEvent,
    family_stage,
)

if TYPE_CHECKING:  # pragma: no cover
    from ..incidents import IncidentEngine

__all__ = ["ReplayReport", "replay_trace"]


@dataclasses.dataclass
class _ActiveFault:
    """A trace fault while live: tick interval + injection parameters."""

    family: str
    rank: int
    delay_s: float
    start_tick: int
    until_tick: int                   # exclusive; -1 = until departure

    def live(self, tick: int) -> bool:
        if tick < self.start_tick:
            return False
        return self.until_tick < 0 or tick < self.until_tick


@dataclasses.dataclass
class _LiveJob:
    """Replay-side state of one running job."""

    job_id: str
    stages: tuple[str, ...]
    sync_stages: tuple[str, ...]
    world_size: int
    roles: tuple[str, ...]
    hosts: tuple[str, ...]
    seed: int
    aggregator: WindowAggregator
    switches: tuple[str, ...] = ()
    pods: tuple[str, ...] = ()
    global_step: int = 0
    faults: list = dataclasses.field(default_factory=list)

    def resize(self, ev: TraceEvent) -> None:
        """Apply a rank-set change: new schema, new aggregator (the old
        window stream cannot continue under a different world size)."""
        self.world_size = ev.world_size
        self.roles = ev.roles()
        self.hosts = ev.hosts
        self.switches = ev.switches
        self.pods = ev.pods
        sc = self._scenario(steps=1, faults=(), seed=0)
        self.aggregator = WindowAggregator(
            sc.schema(), window_steps=self.aggregator.window_steps
        )
        # ranks that no longer exist cannot stay faulted
        self.faults = [f for f in self.faults if f.rank < self.world_size]

    def _scenario(self, *, steps, faults, seed, jitter=0.02) -> Scenario:
        return Scenario(
            stages=self.stages,
            base_means=STAGE_MEANS,
            sync_stages=self.sync_stages,
            world_size=self.world_size,
            steps=steps,
            jitter=jitter,
            seed=seed,
            faults=tuple(faults),
            roles=self.roles,
        )


def _window_faults(
    job: _LiveJob, tick: int, window_steps: int
) -> list[tuple[_ActiveFault, Fault | None]]:
    """Map the job's live trace faults into window-local `sim.Fault`s for
    the window simulated at `tick`.  Family semantics:

      data / step / forward_host   host delay, every step of the window
      backward_comm                slow collective (comm mode), group-wide
      intermittent                 50% duty cycle: faulted on alternating
                                   windows since onset, silent otherwise
      blip                         first active window only, half of it
      drift                        linear ramp from onset over
                                   ~2 windows of steps, then holds

    Returns (active_fault, sim_fault-or-None) pairs; None = the fault is
    live but silent this window (the off-phase of an intermittent).
    """
    out: list[tuple[_ActiveFault, Fault | None]] = []
    for f in job.faults:
        if not f.live(tick) or f.rank >= job.world_size:
            continue
        stage = family_stage(f.family)
        if stage not in job.stages:
            continue
        since = tick - f.start_tick
        sim_fault: Fault | None
        if f.family == "backward_comm":
            sim_fault = Fault(f.rank, stage, f.delay_s, mode="comm")
        elif f.family == "intermittent":
            sim_fault = (
                Fault(f.rank, stage, f.delay_s) if since % 2 == 0 else None
            )
        elif f.family == "blip":
            sim_fault = (
                Fault(f.rank, stage, f.delay_s,
                      end_step=max(1, window_steps // 2))
                if since == 0 else None
            )
        elif f.family == "drift":
            # the ramp spans absolute steps since fault onset: express it
            # window-locally with a (possibly negative) start_step
            sim_fault = Fault(
                f.rank, stage, f.delay_s,
                start_step=-since * window_steps,
                ramp_steps=2 * window_steps,
            )
        else:  # data / step / forward_host: steady host delay
            sim_fault = Fault(f.rank, stage, f.delay_s)
        out.append((f, sim_fault))
    return out


@dataclasses.dataclass
class ReplayReport:
    """Machine-readable replay outcome (see `as_dict`)."""

    trace_name: str = ""
    ticks: int = 0
    window_steps: int = 0
    # volume
    windows_replayed: int = 0
    packets_sent: int = 0
    packets_accepted: int = 0
    wire_bytes: int = 0
    # churn
    arrivals: int = 0
    rearrivals: int = 0
    resizes: int = 0
    departures: int = 0
    evictions: int = 0
    skipped_events: int = 0
    # validation
    scored_windows: int = 0
    ambiguous_windows: int = 0
    hits_top1: int = 0
    hits_top2: int = 0
    rank_hits_top2: int = 0
    per_family: dict = dataclasses.field(default_factory=dict)
    # provenance + service
    loader: dict = dataclasses.field(default_factory=dict)
    snapshot: dict = dataclasses.field(default_factory=dict)
    #: the service's self-observability section (`obs`), split out
    #: of `snapshot` because it carries wall-clock state: the replay's
    #: fused-vs-unfused and sharded-vs-unsharded report-identity
    #: contracts compare `snapshot` bit-for-bit, and timing must not
    #: break them.  Empty dict when the service runs with ``obs=False``.
    obs: dict = dataclasses.field(default_factory=dict)
    #: durable incident table (engine rows) when the incident tier is
    #: attached — empty list otherwise
    incidents: list = dataclasses.field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def accuracy_top1(self) -> float:
        return self.hits_top1 / self.scored_windows if self.scored_windows else 0.0

    @property
    def accuracy_top2(self) -> float:
        return self.hits_top2 / self.scored_windows if self.scored_windows else 0.0

    @property
    def windows_per_s(self) -> float:
        return self.windows_replayed / self.elapsed_s if self.elapsed_s else 0.0

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["accuracy_top1"] = round(self.accuracy_top1, 4)
        out["accuracy_top2"] = round(self.accuracy_top2, 4)
        out["windows_per_s"] = round(self.windows_per_s, 1)
        out["elapsed_s"] = round(self.elapsed_s, 3)
        return out


def _family_bucket(report: ReplayReport, family: str) -> dict:
    return report.per_family.setdefault(
        family, {"scored": 0, "top1": 0, "top2": 0, "unscored": 0}
    )


def replay_trace(
    trace: Trace,
    *,
    wire: str = "sfp2",
    compress: str = "int8",
    top_k: int = 2,
    evict_after: int = 3,
    jitter: float = 0.02,
    min_scored_s: float = 0.05,
    incidents: bool = False,
    service: FleetService | None = None,
    fused: bool = True,
    shards: int | None = None,
    shard_workers: str = "thread",
    obs: bool = True,
    device="cuda",
) -> ReplayReport:
    """Replay `trace` through a `FleetService`; see the module docstring.

    `min_scored_s` is the validation floor: a faulted window is only
    scored when its injected rank-attributable delay reaches this many
    seconds (the early steps of a drift ramp, or the off-phase of an
    intermittent, fall below it and are counted `ambiguous` instead).
    `incidents=True` attaches an `IncidentEngine` so the durable
    incident tier runs over the replay too.  Pass `service` to replay
    into a caller-owned (pre-configured or shared) service instance.
    `fused` picks the kernel refresh path (megakernel vs the
    four-dispatch reference — bit-identical by contract, so the
    resulting reports differ only in wall-clock fields); it is ignored
    when `service` is caller-owned.  `shards` replays through an
    N-shard `fleet.shard.ShardedFleetService` instead (also ignored
    with a caller-owned service) — reports differ from the unsharded
    replay only in wall-clock fields, the second bit-identity contract
    the replay front end validates.  `device` is where the service's and
    the incident engine's kernels run ("cuda", the default, raises
    without a GPU; "cpu" runs their plain versions); it is ignored with
    a caller-owned service.
    """
    report = ReplayReport(
        trace_name=trace.name,
        ticks=trace.ticks,
        window_steps=trace.window_steps,
        loader={
            "rows": trace.stats.rows,
            "accepted": trace.stats.accepted,
            "skipped": trace.stats.skipped,
            "skip_reasons": dict(trace.stats.skip_reasons),
        },
    )
    owned = service is None
    if service is None:
        engine: "IncidentEngine | None" = None
        if incidents:
            from ..incidents import IncidentEngine

            engine = IncidentEngine(device=device)
        if shards:
            from ..fleet import ShardedFleetService

            service = ShardedFleetService(
                shards=shards,
                workers=shard_workers,
                window_capacity=trace.window_steps,
                evict_after=evict_after,
                incidents=engine,
                fused=fused,
                obs=obs,
                device=device,
            )
        else:
            service = FleetService(
                window_capacity=trace.window_steps,
                evict_after=evict_after,
                incidents=engine,
                fused=fused,
                obs=obs,
                device=device,
            )

    live: dict[str, _LiveJob] = {}
    ever_seen: set[str] = set()
    w = trace.window_steps

    by_tick: dict[int, list[TraceEvent]] = {}
    for ev in trace.events:
        by_tick.setdefault(ev.tick, []).append(ev)

    t0 = time.perf_counter()
    for tick in range(trace.ticks):
        # -- 1. trace events -------------------------------------------------
        for ev in by_tick.get(tick, ()):
            if ev.kind == "arrive":
                if ev.job_id in live:
                    report.skipped_events += 1   # double arrival: ignore
                    continue
                if ev.job_id in ever_seen:
                    report.rearrivals += 1
                else:
                    report.arrivals += 1
                ever_seen.add(ev.job_id)
                job = _LiveJob(
                    job_id=ev.job_id,
                    stages=ev.stages,
                    sync_stages=ev.sync_stages,
                    world_size=ev.world_size,
                    roles=ev.roles(),
                    hosts=ev.hosts,
                    switches=ev.switches,
                    pods=ev.pods,
                    seed=ev.seed,
                    aggregator=None,  # type: ignore[arg-type]
                )
                sc = job._scenario(steps=1, faults=(), seed=0)
                job.aggregator = WindowAggregator(sc.schema(), window_steps=w)
                live[ev.job_id] = job
            elif ev.kind == "resize":
                if ev.job_id not in live:
                    report.skipped_events += 1
                    continue
                live[ev.job_id].resize(ev)
                report.resizes += 1
            elif ev.kind == "depart":
                if live.pop(ev.job_id, None) is None:
                    report.skipped_events += 1
                else:
                    report.departures += 1
            elif ev.kind == "fault":
                job = live.get(ev.job_id)
                if job is None or ev.rank >= job.world_size:
                    report.skipped_events += 1
                    continue
                job.faults.append(_ActiveFault(
                    family=ev.family,
                    rank=ev.rank,
                    delay_s=ev.delay_ms / 1000.0,
                    start_tick=ev.tick,
                    until_tick=ev.until_tick,
                ))

        # -- 2. one window per live job, in deterministic order --------------
        batch: list[tuple[str, bytes]] = []
        truths: list[tuple[str, str, int, str]] = []  # scored this tick
        for job_id in sorted(live):
            job = live[job_id]
            pairs = _window_faults(job, tick, w)
            sim_faults = [sf for _, sf in pairs if sf is not None]
            sc = job._scenario(
                steps=w, faults=sim_faults,
                seed=job.seed + job.global_step, jitter=jitter,
            )
            res = simulate(sc)
            rep = None
            for t in range(w):
                rep = job.aggregator.add_step(
                    res.durations[t], res.durations[t].sum(-1)
                ) or rep
            first_step = job.global_step
            job.global_step += w
            if rep is None:  # pragma: no cover - windows close every tick
                continue
            pkt = from_diagnosis(
                rep.diagnosis, job.stages, rep.steps, job.world_size,
                rep.window_index, window=rep.durations,
                present_ranks=tuple(range(job.world_size)),
                sync_stages=job.sync_stages, first_step=first_step,
                hosts=job.hosts, switches=job.switches, pods=job.pods,
            )
            data = encode_packet(pkt, compress=compress, wire=wire)
            batch.append((job_id, data))
            report.wire_bytes += len(data)
            report.windows_replayed += 1

            # -- ground truth for this window --------------------------------
            for af, sf in pairs:
                stage = family_stage(af.family)
                attributable = (
                    sf is not None
                    and sf.mode == "host"
                    and stage not in job.sync_stages
                )
                injected = (
                    sum(sf.delay_at(t) for t in range(w)) if attributable
                    else 0.0
                )
                if af.family in SCORED_FAMILIES and injected >= min_scored_s:
                    truths.append((job_id, stage, sf.rank, af.family))
                else:
                    report.ambiguous_windows += 1
                    _family_bucket(report, af.family)["unscored"] += 1

        # -- 3. ingest -> refresh -> tick -> route -> score ------------------
        report.packets_sent += len(batch)
        report.packets_accepted += service.submit_many(batch, refresh=True)
        service.tick()
        if truths:
            routes = service.route(max(top_k, 2))
            top = [(r.job_id, r.stage, r.rank) for r in routes]
            for job_id, stage, rank, family in truths:
                report.scored_windows += 1
                bucket = _family_bucket(report, family)
                bucket["scored"] += 1
                key = (job_id, stage, rank)
                if key in top[:1]:
                    report.hits_top1 += 1
                    bucket["top1"] += 1
                if key in top[:2]:
                    report.hits_top2 += 1
                    bucket["top2"] += 1
                if any(j == job_id and r == rank for j, _, r in top[:2]):
                    report.rank_hits_top2 += 1

    report.elapsed_s = time.perf_counter() - t0
    report.evictions = service.evicted_total
    report.snapshot = service.snapshot()
    # timing-bearing obs section rides its own report field, keeping
    # `snapshot` deterministic for the report-identity contracts.
    report.obs = report.snapshot.pop("obs", {})
    if getattr(service, "incidents", None) is not None:
        report.incidents = service.incidents.table()
    if owned and shards:
        service.close()
    return report
