"""The tick line: the service's own pipeline as an ordered stage vector.

The paper's pitch is an always-on, additive accounting of where a
distributed step's *exposed* time goes.  This module applies that
accounting to the monitor itself — dogfooding `frontier_accounting`
over the fleet service's tick pipeline:

  - each service **tick** is a "step": the ordered phases
    decode -> stage -> kernel -> epilog -> regimes -> correlate ->
    route (+ a residual, `tick.other_cpu_wall`) are timed with the same
    rank-local `telemetry.StageRecorder` the train loop uses, so the
    per-tick phase vector is residual-closed: phase increments sum to
    the measured wall tick time exactly;
  - each **shard** of a `ShardedFleetService` is a "rank": the
    coordinator stacks the per-shard phase vectors into a
    ``[ticks, shards, phases]`` window and `tick_frontier` runs the
    unmodified `core.frontier.frontier_accounting` over it — the
    frontier increments give an exact additive accounting of the
    coordinator's exposed tick time and name the shard and phase where
    group-visible delay first appears.  A sleep smuggled into one
    shard's decode lane surfaces as (that shard, ``tick.decode``) in
    the frontier table, exactly as a slow rank surfaces in a training
    job's stage shares.

Lifecycle: a tick's step opens lazily at the first instrumented phase
and closes inside `tick()` (`ObsTickline.close_tick`), so work before
the first service call of a round (the caller building its batch) is
excluded, while idle time *between* service calls of the same tick
lands in the residual phase.  Phases recorded after `tick()` (route
queries issued between rounds) accrue to the following tick's vector.
Re-entrant phases — a service method invoking another instrumented
method — are absorbed into the open outer phase (non-overlap holds by
construction; regression-tested).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import deque
from typing import Iterator

import numpy as np

from ..core.contract import StageSchema
from ..core.frontier import frontier_accounting
from ..telemetry.recorder import StageRecorder
from .export import obs_section
from .flight import FlightRecorder
from .metrics import MetricsRegistry

__all__ = [
    "FleetObs",
    "ObsTickline",
    "TICK_PHASES",
    "TickFrontier",
    "tick_frontier",
]

#: ordered tick-pipeline phases (the service's "stages").  The final
#: residual phase absorbs un-instrumented tick time (idle gaps between
#: service calls within one tick) via the recorder's residual closure —
#: the suffix is what `StageSchema.residual_index` keys on.
TICK_PHASES: tuple[str, ...] = (
    "tick.decode",          # wire decode (FleetIngest)
    "tick.stage",           # window staging + device placement
    "tick.kernel",          # fused / four-dispatch kernel dispatch
    "tick.epilog",          # kernel outputs -> per-job registry state
    "tick.regimes",         # streaming folds, eviction, activity build
    "tick.correlate",       # incident engine observe / cross-shard reduce
    "tick.route",           # top-K ranking
    "tick.other_cpu_wall",  # residual: everything else inside the tick
)

#: residual phase index within TICK_PHASES.
_RESIDUAL = len(TICK_PHASES) - 1


def _tick_schema(phases: tuple[str, ...]) -> StageSchema:
    return StageSchema(tuple(phases), version="obs-tickline-1")


class ObsTickline:
    """Per-service tick-phase recorder over a bounded window of ticks.

    Wraps one `telemetry.StageRecorder` (the train loop's rank-local
    span machinery, reused verbatim) and keeps the last `window` closed
    phase vectors + wall times.  `phase(name)` opens the tick's step
    lazily and is re-entrancy safe: a phase opened inside another
    phase's span is a no-op, so the inner time stays charged to the
    outer phase and the ordered-stage non-overlap contract holds.
    """

    def __init__(
        self,
        *,
        phases: tuple[str, ...] = TICK_PHASES,
        window: int = 128,
    ):
        self.phases = tuple(phases)
        self.schema = _tick_schema(self.phases)
        self.recorder = StageRecorder(self.schema, max_history=window)
        self.window = int(window)
        self._vectors: deque[np.ndarray] = deque(maxlen=window)
        self._walls: deque[float] = deque(maxlen=window)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        rec = self.recorder
        if rec.active_stage is not None:
            # re-entrant service call inside an instrumented phase: the
            # wall time is already accruing to the outer span — skip,
            # never nest (and never count it as a contract violation).
            yield
            return
        if not rec.in_step:
            rec.begin_step()
        with rec.stage(name):
            yield

    def close_tick(self) -> tuple[np.ndarray, float]:
        """Close the tick's step (residual closure) and append its phase
        vector; a tick with no instrumented activity appends zeros so
        every logical tick maps to exactly one vector — the alignment a
        multi-shard stack depends on.  Returns ``(vector, wall)``."""
        rec = self.recorder
        if rec.in_step:
            record = rec.end_step()
            vec = np.asarray(record.vector(self.schema), dtype=np.float64)
            wall = record.wall
        else:
            vec = np.zeros(len(self.phases), dtype=np.float64)
            wall = 0.0
        self._vectors.append(vec)
        self._walls.append(wall)
        return vec, wall

    # -- retained window ---------------------------------------------------

    @property
    def ticks(self) -> int:
        return len(self._vectors)

    def vectors(self) -> np.ndarray:
        """Retained phase vectors, ``[ticks, phases]`` float64 seconds."""
        if not self._vectors:
            return np.zeros((0, len(self.phases)), dtype=np.float64)
        return np.stack(tuple(self._vectors))

    def walls(self) -> np.ndarray:
        """Measured wall time per retained tick, ``[ticks]`` seconds."""
        return np.asarray(tuple(self._walls), dtype=np.float64)

    def last_vector(self) -> np.ndarray:
        """Most recent closed phase vector (zeros before any tick)."""
        if not self._vectors:
            return np.zeros(len(self.phases), dtype=np.float64)
        return self._vectors[-1]

    def additivity_errors(self) -> np.ndarray:
        """``|fsum(phases) - wall|`` per retained tick — the exactness
        the paper's Theorem 1 promises, checked on our own pipeline.
        Residual closure makes every entry ~0 (timer resolution)."""
        if not self._vectors:
            return np.zeros(0, dtype=np.float64)
        return np.asarray(
            [
                abs(math.fsum(v) - w)
                for v, w in zip(self._vectors, self._walls)
            ],
            dtype=np.float64,
        )


@dataclasses.dataclass(frozen=True)
class TickFrontier:
    """Frontier accounting of the service's own tick pipeline.

    The output of `tick_frontier` over a ``[ticks, shards, phases]``
    window: per-phase advance seconds and shares (summing to 1 with the
    residual), the modal frontier-leader shard per phase, and the
    headline attribution — the slowest *instrumented* phase and the
    shard leading it (the residual is reported separately as
    `residual_share`: it is time *outside* the pipeline, a driver/idle
    signal, not a pipeline phase to aim a profiler at).
    """

    phases: tuple[str, ...]
    shard_ids: tuple[str, ...]
    ticks: int
    exposed_s: float
    advance_s: tuple[float, ...]
    shares: tuple[float, ...]
    leader: tuple[int, ...]
    slowest_phase: str
    slowest_shard: str
    slowest_share: float
    residual_share: float

    def table(self) -> list[dict]:
        """Per-phase rows for operator output (share descending would
        hide the pipeline order; rows keep declared phase order)."""
        return [
            {
                "phase": p,
                "share": round(self.shares[i], 4),
                "advance_s": round(self.advance_s[i], 6),
                "leader_shard": (
                    self.shard_ids[self.leader[i]] if self.ticks else ""
                ),
            }
            for i, p in enumerate(self.phases)
        ]

    def as_dict(self) -> dict:
        return {
            "ticks": self.ticks,
            "shards": list(self.shard_ids),
            "exposed_s": round(self.exposed_s, 6),
            "table": self.table(),
            "slowest": {
                "shard": self.slowest_shard,
                "phase": self.slowest_phase,
                "share": round(self.slowest_share, 4),
            },
            "residual_share": round(self.residual_share, 4),
        }


def tick_frontier(
    vectors: np.ndarray,
    phases: tuple[str, ...] = TICK_PHASES,
    shard_ids: tuple[str, ...] = ("service",),
) -> TickFrontier:
    """Dogfood `frontier_accounting` over the tick pipeline.

    `vectors` is ``[ticks, shards, phases]`` (or ``[ticks, phases]``
    for a single service) of per-tick phase durations.  Shards are
    "ranks", phases are "stages": the frontier increments decompose the
    coordinator's exposed tick time additively (sum of advances ==
    slowest shard's wall, exactly — Theorem 1), and the per-phase
    leader names the shard whose arrival defines the frontier at that
    boundary, i.e. where group-visible delay first appears.
    """
    d = np.asarray(vectors, dtype=np.float64)
    if d.ndim == 2:
        d = d[:, None, :]
    n_phases = len(phases)
    empty = (0.0,) * n_phases
    if d.size == 0 or d.shape[0] == 0:
        return TickFrontier(
            phases=tuple(phases), shard_ids=tuple(shard_ids), ticks=0,
            exposed_s=0.0, advance_s=empty, shares=empty,
            leader=(0,) * n_phases, slowest_phase="", slowest_shard="",
            slowest_share=0.0, residual_share=0.0,
        )
    if d.shape[1] != len(shard_ids) or d.shape[2] != n_phases:
        raise ValueError(
            f"vectors {d.shape} inconsistent with {len(shard_ids)} "
            f"shards x {n_phases} phases"
        )
    res = frontier_accounting(d)
    advance = res.advances.sum(axis=0)                    # [S]
    exposed = float(res.exposed_makespan.sum())
    shares = advance / exposed if exposed > 0.0 else advance * 0.0
    # modal frontier leader per phase (ties -> lowest shard index)
    leader = tuple(
        int(np.bincount(res.leader[:, s], minlength=d.shape[1]).argmax())
        for s in range(n_phases)
    )
    residual = next(
        (i for i, p in enumerate(phases) if p.endswith("other_cpu_wall")),
        None,
    )
    candidates = [i for i in range(n_phases) if i != residual]
    slowest = max(candidates, key=lambda i: (shares[i], -i))
    return TickFrontier(
        phases=tuple(phases),
        shard_ids=tuple(shard_ids),
        ticks=int(d.shape[0]),
        exposed_s=exposed,
        advance_s=tuple(float(a) for a in advance),
        shares=tuple(float(s) for s in shares),
        leader=leader,
        slowest_phase=phases[slowest],
        slowest_shard=shard_ids[leader[slowest]],
        slowest_share=float(shares[slowest]),
        residual_share=(
            float(shares[residual]) if residual is not None else 0.0
        ),
    )


class FleetObs:
    """One service's self-observability core: metrics + tick line +
    flight recorder, the unit `FleetService` owns (one per shard) and
    `ShardedFleetService` merges.

    Everything here is on by default and bounded: the metrics registry
    grows only with distinct metric names, the tick line and flight
    recorder are fixed-capacity rings.  `benchmarks/obs_overhead.py`
    gates the whole layer's cost at <1% of tick throughput (the paper's
    own always-on budget, with margin over its 0.2% claim).
    """

    def __init__(
        self,
        *,
        name: str = "service",
        window: int = 128,
        flight_capacity: int = 256,
        phases: tuple[str, ...] = TICK_PHASES,
    ):
        self.name = name
        self.metrics = MetricsRegistry()
        self.tickline = ObsTickline(phases=phases, window=window)
        self.flight = FlightRecorder(flight_capacity)

    def phase(self, name: str):
        """Instrumented-phase context (re-entrancy-safe passthrough)."""
        return self.tickline.phase(name)

    # -- event hooks (called by the service layers) ------------------------

    def on_tick(
        self,
        tick: int,
        *,
        evicted: int = 0,
        live: int = 0,
        extra: dict | None = None,
    ) -> tuple[np.ndarray, float]:
        """Close the tick's phase vector and fold it into metrics and
        the flight recorder.  Returns ``(vector, wall)``."""
        vec, wall = self.tickline.close_tick()
        m = self.metrics
        m.counter("ticks").inc()
        if evicted:
            m.counter("jobs_evicted").inc(evicted)
        m.gauge("jobs_live").set(live)
        m.histogram("tick_wall_seconds").observe(wall)
        phase_out = {}
        for p, v in zip(self.tickline.phases, vec):
            if v > 0.0:
                m.histogram("phase_seconds." + p).observe(float(v))
                phase_out[p] = round(float(v), 6)
        event = {
            "wall": round(wall, 6),
            "phases": phase_out,
            "evicted": int(evicted),
            "live": int(live),
        }
        if extra:
            event.update(extra)
        self.flight.record("tick", tick, **event)
        return vec, wall

    def on_route(self, tick: int, entries) -> None:
        """Record one routing decision (top-3 answers into the ring)."""
        self.metrics.counter("route_calls").inc()
        if entries:
            self.flight.record(
                "route", tick,
                top=[(e.job_id, e.stage, e.rank) for e in entries[:3]],
            )

    # -- export ------------------------------------------------------------

    def frontier(self) -> TickFrontier:
        """Single-service tick frontier (one "rank": this service)."""
        return tick_frontier(
            self.tickline.vectors(), self.tickline.phases, (self.name,)
        )

    def section(self) -> dict:
        """The ``snapshot()["obs"]`` payload for this service."""
        return obs_section(self.metrics, self.frontier(), self.flight)
