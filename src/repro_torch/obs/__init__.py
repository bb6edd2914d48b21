"""repro.obs — always-on self-observability for the fleet service.

The paper's discipline applied to its own implementation: the tick
pipeline is instrumented as an ordered stage vector per tick
(`ObsTickline`, reusing `telemetry.StageRecorder`), shards are "ranks",
and `tick_frontier` runs the unmodified `core.frontier` accounting over
the service's own phases — naming the shard and phase where
group-visible tick delay first appears.  `MetricsRegistry` carries
counters/gauges/histograms with a bit-deterministic shard merge
(`merge_registries`), `FlightRecorder` keeps a bounded postmortem ring,
and `export` renders JSON + Prometheus text.  On by default; the
obs-on-vs-off cost is gated <1% by ``benchmarks/obs_overhead.py``.
"""
from .export import obs_section, to_json, to_prometheus
from .flight import FlightRecorder
from .metrics import (
    Counter,
    DEFAULT_EDGES,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_registries,
)
from .tickline import (
    TICK_PHASES,
    FleetObs,
    ObsTickline,
    TickFrontier,
    tick_frontier,
)

__all__ = [
    "Counter",
    "DEFAULT_EDGES",
    "FleetObs",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObsTickline",
    "TICK_PHASES",
    "TickFrontier",
    "merge_registries",
    "obs_section",
    "tick_frontier",
    "to_json",
    "to_prometheus",
]
