"""Bounded ring-buffer flight recorder: the last N tick events, always.

Always-on means bounded: the flight recorder keeps a fixed-capacity
ring of recent tick-pipeline events (phase vectors, route decisions,
eviction/drop counters, incident state) that a postmortem can `dump()`
after the fact — "what were the last 256 ticks doing" without any
logging infrastructure in the hot path.  Overwritten events are counted
(`dropped`), never silently lost from the books.
"""
from __future__ import annotations

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Fixed-capacity ring of JSON-clean event dicts.

    `record(kind, tick, **fields)` appends one event; once the ring is
    full the oldest event is overwritten and `dropped` increments.
    `dump()` returns copies in arrival order (oldest first) — safe to
    serialize or mutate without touching the ring.
    """

    __slots__ = ("capacity", "dropped", "_events", "_start")

    def __init__(self, capacity: int = 256):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dropped = 0
        self._events: list[dict] = []
        self._start = 0  # ring head when full

    def record(self, kind: str, tick: int, **fields) -> None:
        event = {"kind": str(kind), "tick": int(tick), **fields}
        if len(self._events) < self.capacity:
            self._events.append(event)
            return
        self._events[self._start] = event
        self._start = (self._start + 1) % self.capacity
        self.dropped += 1

    def dump(self) -> list[dict]:
        """Events oldest-first, as copies (postmortem export)."""
        ordered = self._events[self._start:] + self._events[: self._start]
        return [dict(e) for e in ordered]

    def last(self) -> dict | None:
        if not self._events:
            return None
        return dict(self._events[(self._start - 1) % len(self._events)])

    def __len__(self) -> int:
        return len(self._events)
