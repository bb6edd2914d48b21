"""Process-local metrics registry with a deterministic shard merge.

The self-observability substrate (`repro.obs`): monotonic counters,
integer gauges, and fixed-bucket histograms a service mutates on its hot
path and exports on demand (`docs/observability.md`).

The load-bearing property is the **merge law**: per-shard registries
reduce to one fleet view *bit-identically regardless of shard count,
merge order, or submission interleaving* — the same discipline the
sharded service's snapshot parity established for the fleet counters.  It holds because
every accumulator is an exact integer:

  - counters and gauges hold Python ints (arbitrary precision, so sums
    never saturate or round);
  - histograms bucket on float values but accumulate their sum as
    integer *nanoseconds* (``round(value * 1e9)``), so the merged sum is
    an exact integer sum and only converts to float once, at export.

Integer addition is commutative and associative, so
``merge_registries([a, b, c]) == merge_registries([c, a, b])`` exactly,
and partitioning one observation stream across N registries then
merging yields the identical export for every N — property-tested in
``tests/test_obs_properties.py`` (mirrors ``test_shard_properties.py``).

Histogram bucket edges are fixed at construction and must agree across
merge inputs (a merge across disagreeing edge vectors is a programming
error and raises — silently resampling buckets would fabricate data).
"""
from __future__ import annotations

import bisect
import dataclasses

__all__ = [
    "Counter",
    "DEFAULT_EDGES",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "merge_registries",
]

#: default histogram bucket edges, in seconds — latency-shaped, spanning
#: 10 µs wire decodes to multi-second stalls.  Observations land in the
#: first bucket whose edge is >= the value; values past the last edge
#: land in the overflow bucket.
DEFAULT_EDGES: tuple[float, ...] = (
    1e-5, 1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
    5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0,
)

#: nanoseconds per second — the histogram sum's integer unit.
_NS = 1_000_000_000


@dataclasses.dataclass
class Counter:
    """Monotonic integer counter.  `inc` rejects negative deltas: a
    counter that can run backwards is a gauge wearing the wrong name
    (a `windows_seen` that ran backwards on eviction is the cautionary
    tale)."""

    value: int = 0

    def inc(self, n: int = 1) -> None:
        n = int(n)
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n


@dataclasses.dataclass
class Gauge:
    """Integer-valued gauge (`set`/`add`).  Integer-only on purpose: the
    shard merge sums gauges (each shard reports its own live-jobs /
    buffer-depth slice of a fleet total), and integer sums are exact
    under any merge order — a float gauge would make the merged export
    depend on summation order in the last ulp."""

    value: int = 0

    def set(self, value: int) -> None:
        self.value = int(value)

    def add(self, n: int = 1) -> None:
        self.value += int(n)


class Histogram:
    """Fixed-bucket histogram with an exact-integer sum.

    ``counts[i]`` is the number of observations with
    ``value <= edges[i]`` (and above the previous edge); ``counts[-1]``
    is the overflow bucket.  ``sum_seconds`` is accumulated as integer
    nanoseconds so shard merges stay bit-identical (module docstring).
    """

    __slots__ = ("edges", "counts", "count", "sum_ns")

    def __init__(self, edges: tuple[float, ...] = DEFAULT_EDGES):
        edges = tuple(float(e) for e in edges)
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"bucket edges must strictly ascend: {edges}")
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.sum_ns = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.counts[bisect.bisect_left(self.edges, value)] += 1
        self.count += 1
        self.sum_ns += round(value * _NS)

    @property
    def sum_seconds(self) -> float:
        return self.sum_ns / _NS

    def as_dict(self) -> dict:
        return {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum_ns / _NS,
        }


class MetricsRegistry:
    """Get-or-create registry of named counters, gauges and histograms.

    One registry per service shard; mutation is get-or-create plus an
    integer add, so the hot path never allocates after first touch.  A
    name owns exactly one metric kind for the registry's lifetime —
    re-registering it as another kind raises.  Exports are sorted by
    name, so two registries with equal contents export equal dicts.
    """

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # -- get-or-create -----------------------------------------------------

    def _claim(self, name: str, kind: dict) -> None:
        for other in (self._counters, self._gauges, self._histograms):
            if other is not kind and name in other:
                raise ValueError(
                    f"metric name {name!r} already registered as a "
                    f"different kind"
                )

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._claim(name, self._counters)
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._claim(name, self._gauges)
            g = self._gauges[name] = Gauge()
        return g

    def histogram(
        self, name: str, edges: tuple[float, ...] | None = None
    ) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            self._claim(name, self._histograms)
            h = self._histograms[name] = Histogram(edges or DEFAULT_EDGES)
        elif edges is not None and tuple(edges) != h.edges:
            raise ValueError(
                f"histogram {name!r} already registered with edges "
                f"{h.edges}, got {tuple(edges)}"
            )
        return h

    # -- introspection / export --------------------------------------------

    def counters(self) -> dict[str, int]:
        return {n: c.value for n, c in sorted(self._counters.items())}

    def gauges(self) -> dict[str, int]:
        return {n: g.value for n, g in sorted(self._gauges.items())}

    def histograms(self) -> dict[str, Histogram]:
        return dict(sorted(self._histograms.items()))

    def as_dict(self) -> dict:
        """Deterministic JSON-clean export (sorted names, exact sums)."""
        return {
            "counters": self.counters(),
            "gauges": self.gauges(),
            "histograms": {
                n: h.as_dict() for n, h in sorted(self._histograms.items())
            },
        }

    def __len__(self) -> int:
        return (
            len(self._counters) + len(self._gauges) + len(self._histograms)
        )


def merge_registries(
    registries: "list[MetricsRegistry] | tuple[MetricsRegistry, ...]",
) -> MetricsRegistry:
    """Reduce per-shard registries to one fleet registry.

    Counters and gauges sum; histograms sum per-bucket counts, total
    counts, and the integer nanosecond sums.  All accumulation is exact
    integer arithmetic, so the result is bit-identical for every input
    order and every partition of the underlying observation stream
    (module docstring; property-tested).  Metric names union; histogram
    edge disagreement raises.
    """
    out = MetricsRegistry()
    for reg in registries:
        for name, c in reg._counters.items():
            out.counter(name).inc(c.value)
        for name, g in reg._gauges.items():
            out.gauge(name).add(g.value)
        for name, h in reg._histograms.items():
            merged = out.histogram(name, h.edges)
            if merged.edges != h.edges:  # pragma: no cover - raised above
                raise ValueError(f"histogram {name!r} edge mismatch")
            for i, n in enumerate(h.counts):
                merged.counts[i] += n
            merged.count += h.count
            merged.sum_ns += h.sum_ns
    return out
