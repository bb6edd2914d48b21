"""Exposition: JSON section + Prometheus text format for `repro.obs`.

Two consumers, two shapes:

  - `obs_section(metrics, frontier, flight)` builds the JSON-clean
    ``"obs"`` dict that `FleetService.snapshot()`, the sharded merge,
    `serve_fleet`, and `launch/replay` all embed (field-by-field docs in
    ``docs/observability.md``);
  - `to_prometheus(registry)` renders a `MetricsRegistry` in the
    Prometheus text exposition format (counters as ``_total``,
    histograms as cumulative ``_bucket{le=...}`` series plus ``_sum`` /
    ``_count``) for scraping without a client-library dependency.

This module deliberately imports nothing from `tickline` (which imports
it), keeping the package acyclic.
"""
from __future__ import annotations

import json

from .flight import FlightRecorder
from .metrics import MetricsRegistry

__all__ = ["obs_section", "to_json", "to_prometheus"]

_SAN = str.maketrans({".": "_", "-": "_", "/": "_", " ": "_"})


def _name(prefix: str, name: str) -> str:
    return (prefix + "_" + name).translate(_SAN)


def _fmt(value: float) -> str:
    """Prometheus float formatting: integral values without exponent."""
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def to_prometheus(registry: MetricsRegistry, *, prefix: str = "repro") -> str:
    """Render a registry in the Prometheus text exposition format.

    Deterministic: metric names are sorted (the registry's export
    order), so two registries with equal contents render equal text —
    the merge law carries through to the wire format.
    """
    lines: list[str] = []
    for name, value in registry.counters().items():
        metric = _name(prefix, name) + "_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {value}")
    for name, value in registry.gauges().items():
        metric = _name(prefix, name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {value}")
    for name, hist in registry.histograms().items():
        metric = _name(prefix, name)
        lines.append(f"# TYPE {metric} histogram")
        cumulative = 0
        for edge, count in zip(hist.edges, hist.counts):
            cumulative += count
            lines.append(
                f'{metric}_bucket{{le="{_fmt(edge)}"}} {cumulative}'
            )
        lines.append(f'{metric}_bucket{{le="+Inf"}} {hist.count}')
        lines.append(f"{metric}_sum {_fmt(hist.sum_seconds)}")
        lines.append(f"{metric}_count {hist.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def obs_section(
    metrics: MetricsRegistry,
    frontier,
    flight: FlightRecorder,
) -> dict:
    """The ``snapshot()["obs"]`` payload (JSON-clean, documented in
    ``docs/observability.md``).  `frontier` is a `TickFrontier` (duck:
    anything with ``as_dict()``)."""
    return {
        "metrics": metrics.as_dict(),
        "tick_frontier": frontier.as_dict(),
        "flight": {
            "events": len(flight),
            "capacity": flight.capacity,
            "dropped": flight.dropped,
        },
    }


def to_json(section: dict, *, indent: int | None = None) -> str:
    """Serialize an obs section (convenience for CLIs / postmortems)."""
    return json.dumps(section, indent=indent, sort_keys=True)
