"""Sampled device-time side channel — the paper's CUDA-event forward
channel (§5).

PyTorch launches CUDA work asynchronously, so a step's device time is not
visible to CPU-wall spans unless the host blocks.  The train loop records
a `torch.cuda.Event` on the current stream right after a step's dispatch
and hands it over; the channel keeps the dispatch timestamp of a sampled
step's event and polls `event.query()` at later safe points, yielding
dispatch->ready latency — device-stream elapsed time for the sampled
region — without ever blocking the hot path.

The sample value is SIDE EVIDENCE ONLY: it never enters the prefix vector
(it feeds the EventSummary consumed by the labeler's device-evidence axis).
Deterministic sampling at fraction q in {0, 0.05, 1} mirrors the paper.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

__all__ = ["DeviceEventChannel"]


def _is_ready(x: Any) -> bool:
    try:
        return bool(x.query())
    except AttributeError:  # a CPU tensor or any handle without query()
        return True


@dataclasses.dataclass
class _Pending:
    step: int
    dispatched_at: float
    cpu_wall_ms: float
    handle: Any


class DeviceEventChannel:
    """Deterministic-fraction sampling of dispatch->ready latency."""

    def __init__(self, q: float = 0.05, *, max_pending: int = 8):
        if q < 0 or q > 1:
            raise ValueError("q must be in [0, 1]")
        self.q = q
        self._period = 0 if q == 0 else max(1, round(1 / q))
        self._pending: list[_Pending] = []
        self._max_pending = max_pending
        #: completed samples: (step, device_ms, cpu_wall_ms)
        self.samples: list[tuple[int, float, float]] = []
        self.attempts = 0
        self.dropped = 0

    def should_sample(self, step: int) -> bool:
        return self._period > 0 and step % self._period == 0

    def observe(self, step: int, output: Any, cpu_wall_ms: float) -> None:
        """Register a sampled step's handle (a `torch.cuda.Event` recorded
        right after dispatch); never blocks."""
        if not self.should_sample(step):
            return
        self.attempts += 1
        if len(self._pending) >= self._max_pending:  # bounded queue
            self._pending.pop(0)
            self.dropped += 1
        self._pending.append(
            _Pending(step, time.perf_counter(), cpu_wall_ms, output)
        )

    def poll(self) -> list[tuple[int, float, float]]:
        """Check pending handles at a safe point; returns newly-ready
        samples (step, device_ms, cpu_wall_ms)."""
        now = time.perf_counter()
        ready: list[tuple[int, float, float]] = []
        still: list[_Pending] = []
        for p in self._pending:
            if _is_ready(p.handle):
                ready.append((p.step, (now - p.dispatched_at) * 1e3, p.cpu_wall_ms))
            else:
                still.append(p)
        self._pending = still
        self.samples.extend(ready)
        return ready

    @property
    def ready_ratio(self) -> float:
        return len(self.samples) / self.attempts if self.attempts else 0.0
