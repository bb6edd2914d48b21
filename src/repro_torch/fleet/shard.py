"""Sharded multi-worker fleet service: horizontal scale-out of the
always-on signal.

This module partitions the fleet by a STABLE job-id hash across N worker
shards, each owning its jobs' full vertical slice (wire ingest ->
registry -> `WindowStager` -> tick kernel refresh -> regime state),
behind a thin `ShardedFleetService` coordinator that keeps the
single-process `FleetService` API: ``submit`` / ``submit_many`` /
``tick`` / ``route`` / ``snapshot`` / ``incidents``.

Correctness contract — the part a sharded service can silently break and
only a differential rig can pin (``tests/test_torch_shard.py``):

  * **routing** — per-job evidence is shard-local (windows of one job
    never cross shards, and the tick's per-job results do not depend on
    the jobs that share its launch), so every shard's `route` entries
    are bit-identical to the unsharded service's; the coordinator merges
    them under the SAME total ``(-score, job_id, rank)`` order the
    single service sorts by.  The total key is load-bearing: a merge
    that breaks score ties per shard would reorder equal-score jobs that
    hash to different shards — the tie-order hazard `route` asserts
    against.
  * **incidents** — common-cause correlation must see the WHOLE fleet,
    so the coordinator owns the one `IncidentEngine`.  Each tick it
    derives a `CorrelationGroup` plan from merged activity metadata,
    every shard folds its own jobs' rank-level activity onto the plan's
    candidate host axes (`incidents.fold_host_activity`), and the
    coordinator stacks the partials in plan order and scores them with
    the co-activation kernel: the explicit cross-shard reduce,
    bit-identical to the single-process engine.
  * **counters** — ingest/registry counters are per-shard sums;
    `snapshot()` recomputes derived ratios from the summed raw
    counters, so the merged snapshot equals the unsharded one.

The one case where sharded answers may differ: conflicting fabric
claims across shards within one `submit_many` batch.  Shards declare
placements into the coordinator engine's one `Topology` (its writes are
locked) as their lanes ingest, and fabric maps are last-writer-wins:
when jobs on different shards claim different switches for one host (or
pods for one switch) in the same batch, the winner — and with three or
more such claims the `rehomed` count — follows the lanes' scheduling
(thread) or shard order (inline), where the unsharded service follows
arrival order.  A job's own placement lives on one shard and keeps its
arrival order; batches are applied one after another, so claims of
different batches keep theirs too.

Worker model: ``workers="thread"`` (default) gives each shard a
single-thread executor — one tick's sub-batches decode and fold
concurrently, so shard B's wire decode overlaps shard A's kernel launch
(the `ctypes` launch releases the interpreter lock): the async ingest
lane.  ``workers="inline"`` runs shards one after another on the
caller's thread (the deterministic debugging reference — outputs are
identical either way, only wall-clock differs).

Placement: every shard runs its tick kernels on a torch device —
``device`` ("cuda" by default; raises without a GPU, never falls back to
the CPU), or with ``devices="auto"`` and more than one visible card,
``cuda:0 .. cuda:n-1`` round-robin; an explicit sequence of devices is
round-robined as given.  Each shard on a CUDA device owns a CUDA stream
on it, and every call the coordinator makes into that shard runs with
that stream current (entered inside the lane's thread: the current
stream is per thread), so N shards on one card launch on N streams and
each shard waits only for its own.  Shards hand the coordinator NumPy
arrays only; no tensor crosses streams.
"""
from __future__ import annotations

import contextlib
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np
import torch

from ..obs import FleetObs, merge_registries, obs_section, tick_frontier
from ..telemetry.packets import EvidencePacket
from .registry import JobState
from .service import FleetService, RouteEntry

if TYPE_CHECKING:  # pragma: no cover
    from ..incidents import IncidentEngine

__all__ = ["ShardedFleetService", "job_id_for_shard", "shard_of"]


def shard_of(job_id: str, shards: int) -> int:
    """Owning shard of `job_id` among `shards` workers.

    Stable by construction (CRC-32 of the UTF-8 id — never Python's
    salted `hash`): the same job lands on the same shard across
    processes, restarts, and runs, so re-arrivals and duplicate windows
    keep hitting the registry state that knows them.
    """
    if shards <= 0:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return zlib.crc32(job_id.encode("utf-8")) % shards


def job_id_for_shard(
    base: str, shard: int, shards: int, *, sep: str = "~"
) -> str:
    """Deterministic job id derived from `base` that hashes to `shard`.

    Test/scenario helper (e.g. `sim.scenarios.shared_host_fleet`'s
    shard-splitting placement): returns `base` itself when it already
    lands on `shard`, else the first ``{base}{sep}{i}`` that does —
    deterministic, so fixtures and differential runs agree on ids.
    """
    if not 0 <= shard < shards:
        raise ValueError(f"shard {shard} outside [0, {shards})")
    if shard_of(base, shards) == shard:
        return base
    i = 0
    while True:
        cand = f"{base}{sep}{i}"
        if shard_of(cand, shards) == shard:
            return cand
        i += 1


class ShardedFleetService:
    """N-shard fleet coordinator with the `FleetService` serving API.

    Every submit routes to ``shards[shard_of(job_id, n)]``; `tick`,
    `route`, and `snapshot` merge the per-shard answers under the same
    deterministic orders the single-process service uses, and the
    optional `IncidentEngine` runs fleet-wide at the coordinator fed by
    the cross-shard activity reduce (module docstring).  The merged
    outputs are bit-identical to one `FleetService` ingesting the same
    packets, but for conflicting fabric claims across shards within one
    batch (module docstring).
    """

    #: the total route order shared with `FleetService.route` — merge
    #: stability across shard boundaries REQUIRES the full key (score
    #: ties between jobs on different shards must still order by
    #: (job_id, rank), never by shard position).
    _ROUTE_KEY = staticmethod(lambda e: (-e.score, e.job_id, e.rank))

    def __init__(
        self,
        *,
        shards: int = 8,
        workers: str = "thread",
        window_capacity: int = 100,
        evict_after: int = 10,
        degrade_after: int = 3,
        max_jobs: int = 100_000,
        regime_windows: int = 4,
        incidents: "IncidentEngine | None" = None,
        fused: bool = True,
        device="cuda",
        devices: str | Sequence | None = "auto",
        obs: bool = True,
    ):
        if shards <= 0:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if workers not in ("thread", "inline"):
            raise ValueError(f"workers must be thread|inline: {workers!r}")
        self.n_shards = int(shards)
        self.workers = workers
        self.incidents = incidents
        placements = self._resolve_devices(device, devices)
        topo = incidents.topology if incidents is not None else None
        #: per-shard bound: each worker refuses new registrations past
        #: `max_jobs`, so the aggregate bound is shards * max_jobs; with
        #: a balanced hash the unsharded `rejected_total` semantics are
        #: preserved for any fleet that fits one service's bound.
        self.shards = [
            FleetService(
                window_capacity=window_capacity,
                evict_after=evict_after,
                degrade_after=degrade_after,
                max_jobs=max_jobs,
                regime_windows=regime_windows,
                incidents=None,
                fused=fused,
                topology=topo,
                device=placements[i],
                obs=obs,
                obs_name=f"shard-{i}",
            )
            for i in range(self.n_shards)
        ]
        #: one CUDA stream per shard on a CUDA device (None on the CPU):
        #: the shards' launches, copies and waits stay on their own stream
        self._streams = [
            torch.cuda.Stream(s.device) if s.device.type == "cuda" else None
            for s in self.shards
        ]
        #: coordinator-side self-observability: its own tick phases
        #: (route gather, cross-shard correlate) plus the dogfooded
        #: multi-rank frontier — shards are "ranks", tick phases are
        #: "stages".  Each tick stacks every shard's closed phase vector
        #: with the coordinator's own into a [shards+1, phases] row;
        #: `snapshot()["obs"]` runs `core.frontier.frontier_accounting`
        #: over the retained [ticks, shards+1, phases] window, naming
        #: the shard and phase where group-visible tick delay first
        #: appears (tests inject a one-shard stall and assert exactly
        #: that attribution).
        self.obs = FleetObs(name="coord") if obs else None
        self._tick_rows: deque[np.ndarray] = deque(maxlen=128)
        self._obs_ids = tuple(
            f"shard-{i}" for i in range(self.n_shards)
        ) + ("coord",)
        #: one single-thread lane per shard: work for a shard serializes
        #: (its state has exactly one writer), work ACROSS shards
        #: overlaps — decode on lane B runs while lane A's kernel launch
        #: holds no interpreter lock.
        self._lanes = (
            [ThreadPoolExecutor(max_workers=1) for _ in self.shards]
            if workers == "thread"
            else None
        )
        self._tick = 0

    def _resolve_devices(self, device, devices) -> list[torch.device]:
        """Each shard's torch device.

        ``"auto"``: with more than one visible card and a CUDA `device`,
        round-robin the shards over ``cuda:0 .. cuda:n-1``; otherwise
        every shard uses `device`.  An explicit sequence of devices is
        round-robined as given; ``None`` pins nothing (every shard uses
        `device`).
        """
        device = torch.device(device)
        if isinstance(devices, str):
            if devices != "auto":
                raise ValueError(
                    f"devices must be 'auto', None or a sequence: {devices!r}"
                )
            count = (
                torch.cuda.device_count()
                if device.type == "cuda" and torch.cuda.is_available()
                else 0
            )
            devices = (
                [torch.device("cuda", i) for i in range(count)]
                if count > 1
                else None
            )
        devices = [torch.device(d) for d in devices or ()] or [device]
        return [devices[i % len(devices)] for i in range(self.n_shards)]

    # -- ingest ------------------------------------------------------------

    @property
    def current_tick(self) -> int:
        return self._tick

    @property
    def evicted_total(self) -> int:
        return sum(s.evicted_total for s in self.shards)

    def shard_index(self, job_id: str) -> int:
        """Owning shard index of `job_id` (the stable hash partition)."""
        return shard_of(job_id, self.n_shards)

    def partition(
        self, items: Iterable[tuple[str, bytes | EvidencePacket]]
    ) -> list[list[tuple[str, bytes | EvidencePacket]]]:
        """Split one tick's ``(job_id, wire)`` batch into per-shard
        sub-batches, preserving each shard's arrival order.  Public so
        benchmarks/drivers can measure or ship the per-shard lanes
        themselves."""
        parts: list[list] = [[] for _ in range(self.n_shards)]
        for item in items:
            parts[shard_of(item[0], self.n_shards)].append(item)
        return parts

    def submit(
        self, job_id: str, data: bytes | EvidencePacket
    ) -> JobState | None:
        """Ingest one packet on the owning shard (same contract as
        `FleetService.submit`)."""
        i = shard_of(job_id, self.n_shards)
        return self._on_stream(i, lambda s, _: s.submit(job_id, data), None)

    def submit_many(
        self,
        items: Iterable[tuple[str, bytes | EvidencePacket]],
        *,
        refresh: bool = False,
    ) -> int:
        """Partition one tick's batch across the shards and ingest each
        sub-batch on its worker lane; returns total accepted.

        With ``workers="thread"`` the per-shard decode -> fold ->
        (optional) kernel refresh pipelines run concurrently — the
        async ingest lane.  The call itself is synchronous: it returns
        only when every lane drained, so the coordinator's state is
        quiescent between calls and the API stays drop-in.
        """
        parts = self.partition(items)
        return sum(
            self._map_shards(
                lambda s, part: s.submit_many(part, refresh=refresh), parts
            )
        )

    def refresh_batched(
        self, *, min_jobs: int = 1, fused: bool | None = None
    ) -> int:
        """Kernel-refresh every shard's dirty jobs; returns total."""
        return sum(
            self._map_shards(
                lambda s, _: s.refresh_batched(min_jobs=min_jobs, fused=fused)
            )
        )

    def _on_stream(self, i: int, fn, arg):
        """``fn(shard i, arg)`` with shard i's stream current on this
        thread (its lane's, or the caller's when inline)."""
        stream = self._streams[i]
        ctx = (
            torch.cuda.stream(stream)
            if stream is not None
            else contextlib.nullcontext()
        )
        with ctx:
            return fn(self.shards[i], arg)

    def _map_shards(self, fn, args: Sequence | None = None) -> list:
        """Run ``fn(shard, arg)`` on every shard — concurrently on the
        worker lanes, or inline — each with its stream current, and
        return results in shard order."""
        args = args if args is not None else [None] * self.n_shards
        if self._lanes is None:
            return [self._on_stream(i, fn, a) for i, a in enumerate(args)]
        futs = [
            lane.submit(self._on_stream, i, fn, a)
            for i, (lane, a) in enumerate(zip(self._lanes, args))
        ]
        return [f.result() for f in futs]

    # -- the fleet tick ----------------------------------------------------

    def tick(self) -> list[str]:
        """Advance the fleet clock on every shard; returns evicted ids.

        With an incident engine attached, the coordinator then runs the
        fleet-wide fold the single-process `FleetService.tick` runs
        locally: the merged route answer (every routable job on every
        shard), the merged evictions, and the cross-shard activity
        reduce — metadata up, `CorrelationGroup` plan down, host-folded
        partials up, one tiered co-activation scoring pass over the
        merged host axis (fabric tiers OR-collapse from the same
        partials on the coordinator).
        """
        self._tick += 1
        evicted: list[str] = []
        for ev in self._map_shards(lambda s, _: s.tick()):
            evicted.extend(ev)
        if self.incidents is not None:
            entries: list[RouteEntry] = []
            with self._phase("tick.route"):
                for part in self._map_shards(
                    lambda s, _: s.route(len(s.registry))
                ):
                    entries.extend(part)
            with self._phase("tick.correlate"):
                self.incidents.observe(
                    self._tick,
                    entries,
                    evicted=evicted,
                    folded=self._folded_activity(),
                )
        if self.obs is not None:
            vec, _ = self.obs.on_tick(
                self._tick, evicted=len(evicted), live=len(self)
            )
            # the dogfooded frontier row: every shard's just-closed tick
            # vector (each shard's `tick()` on its lane closed the step)
            # stacked with the coordinator's own — "ranks" x "stages".
            self._tick_rows.append(
                np.stack(
                    [s.obs.tickline.last_vector() for s in self.shards]
                    + [vec]
                )
            )
        return evicted

    def _phase(self, name: str):
        """Coordinator-side tick-phase span (no-op when obs is off)."""
        if self.obs is None:
            return contextlib.nullcontext()
        return self.obs.phase(name)

    def _shard_activity(self, shard: FleetService) -> dict:
        """One shard's per-job activity series (the engine substrate)."""
        return {
            job.job_id: (job.regimes.activity(), job.stages)
            for job in shard.registry.jobs()
            if job.regimes is not None and job.regimes.num_steps
        }

    def _folded_activity(self):
        """The cross-shard activity reduce, coordinator side.

        1. every shard emits activity METADATA (id -> depth, stages);
        2. the engine plans `CorrelationGroup`s over the merged view;
        3. every shard folds its own jobs' activity onto each group's
           candidate-host axis (the per-(host, stage) partials);
        4. partials stack in ``group.job_ids`` order — the exact array
           the single-process fold builds — ready for co-activation.

        Only host-folded bool series cross the shard boundary, as NumPy
        arrays: the reduce ships O(steps x candidate hosts x stages) per
        member, not rank-level state.  The fabric tiers ride the same
        partials — each group's plan carries the host-column ->
        switch/pod-column groupings, and the scoring side OR-collapses
        the stacked host partials onto them, so tier promotion is
        bit-identical to unsharded without any tier-shaped wire format.
        """
        from ..incidents.engine import activity_meta, fold_host_activity

        engine = self.incidents
        activities = self._map_shards(
            lambda s, _: self._shard_activity(s)
        )
        meta: dict = {}
        for act in activities:
            meta.update(activity_meta(act))
        plan = engine.correlation_plan(meta)
        if not plan:
            return []
        partial_sets = self._map_shards(
            lambda s, act: [
                fold_host_activity(g, act, engine.topology) for g in plan
            ],
            activities,
        )
        folded = []
        for gi, group in enumerate(plan):
            parts: dict[str, np.ndarray] = {}
            for per_shard in partial_sets:
                parts.update(per_shard[gi])
            folded.append(
                (group, np.stack([parts[j] for j in group.job_ids]))
            )
        return folded

    # -- routing -----------------------------------------------------------

    def route(self, k: int = 10) -> list[RouteEntry]:
        """Global top-K by persistence-weighted recoverable seconds.

        Each shard answers its local top-K; because the route order is
        TOTAL, the global top-K is a subset of the union, and one merge
        under the same ``(-score, job_id, rank)`` key reproduces the
        unsharded answer bit for bit.  Tie stability across merge
        boundaries is asserted: two jobs with equal scores on different
        shards must order by (job_id, rank) exactly as they would inside
        one service.
        """
        merged: list[RouteEntry] = []
        with self._phase("tick.route"):
            for part in self._map_shards(lambda s, _: s.route(k)):
                merged.extend(part)
            merged.sort(key=self._ROUTE_KEY)
            out = merged[: max(0, k)]
        if self.obs is not None:
            self.obs.on_route(self._tick, out)
        # the tie-order contract: the merged prefix must be strictly
        # increasing under the TOTAL key — equal keys would mean one
        # (job, rank) surfaced from two shards, and a non-total
        # comparison could order them differently per run.
        assert all(
            self._ROUTE_KEY(a) < self._ROUTE_KEY(b)
            for a, b in zip(out, out[1:])
        ), "route merge lost total (score, job_id, rank) order"
        return out

    # -- summaries ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Merged fleet snapshot, field-for-field equal to the unsharded
        `FleetService.snapshot` on the same traffic: raw counters are
        per-shard sums and every derived ratio is recomputed from the
        summed counters (averaging per-shard averages would not be
        exact)."""
        shots = self._map_shards(lambda s, _: s.snapshot())
        regimes: dict[str, int] = {}
        for shot in shots:
            for name, c in shot["regimes"].items():
                regimes[name] = regimes.get(name, 0) + c
        out = {
            "tick": self._tick,
            "jobs": sum(s["jobs"] for s in shots),
            "degraded_jobs": sum(s["degraded_jobs"] for s in shots),
            "regimes": regimes,
            "evicted_total": sum(s["evicted_total"] for s in shots),
            "rejected_total": sum(s["rejected_total"] for s in shots),
            "duplicate_total": sum(s["duplicate_total"] for s in shots),
            "packets": sum(s["packets"] for s in shots),
            "bytes": sum(s["bytes"] for s in shots),
            "decode_errors": sum(s["decode_errors"] for s in shots),
            "predecoded": sum(s["predecoded"] for s in shots),
            "windows_seen": sum(s["windows_seen"] for s in shots),
        }
        wire_packets = out["packets"] - out["predecoded"]
        out["avg_wire_bytes"] = (
            out["bytes"] / wire_packets if wire_packets else 0.0
        )
        if self.incidents is not None:
            out["incidents"] = self.incidents.counts()
            # topology churn counter lives on the coordinator engine
            # (shards declare into its topology, never their own) — no
            # per-shard summing, or re-homings would double-count.
            out["rehomed"] = self.incidents.topology.rehomed
        if self.obs is not None:
            # merged self-observability: per-shard metric registries
            # reduce through the order-insensitive integer merge, and
            # the tick frontier runs over the retained
            # [ticks, shards+1, phases] stack — the paper's accounting
            # naming the shard and phase behind slow coordinator ticks.
            merged_metrics = merge_registries(
                [s.obs.metrics for s in self.shards] + [self.obs.metrics]
            )
            rows = (
                np.stack(tuple(self._tick_rows))
                if self._tick_rows
                else np.zeros(
                    (0, self.n_shards + 1, len(self.obs.tickline.phases))
                )
            )
            out["obs"] = obs_section(
                merged_metrics,
                tick_frontier(rows, self.obs.tickline.phases, self._obs_ids),
                self.obs.flight,
            )
        return out

    def __len__(self) -> int:
        return sum(len(s.registry) for s in self.shards)

    def close(self) -> None:
        """Shut the worker lanes down (idempotent; inline mode no-op).

        The service stays usable afterwards — subsequent calls run
        inline on the caller's thread, each under its shard's stream,
        so a driver may close the lanes when ingest ends and still read
        `route`/`snapshot`."""
        if self._lanes is not None:
            lanes, self._lanes = self._lanes, None
            for lane in lanes:
                lane.shutdown(wait=True)

    def __enter__(self) -> "ShardedFleetService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
