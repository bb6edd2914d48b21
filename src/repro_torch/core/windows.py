"""Streaming window aggregation (paper §3, §5).

A `WindowAggregator` consumes one [R, S] rank-stage matrix per step (plus
the rank-local step wall times), enforces the ordered-stage contract, and
closes a window every `window_steps` steps — or early on contract breaks
(schema change, world-size change, accumulation-factor change).  Queues are
bounded: always-on means bounded queues, symmetric failure-safe collection
and conservative downgrades.

The aggregator performs the O(R*S)-memory streaming form of the frontier
pass: per step it needs only that step's matrix; window accumulators keep
sums, not histories (histories are optional, for the gain baseline, and are
bounded by `window_steps`).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterable

import numpy as np

from .contract import ClosureReport, StageSchema, close_residual
from .labeler import Diagnosis, EventSummary, LabelerGates, diagnose

__all__ = ["WindowAggregator", "WindowReport"]


@dataclasses.dataclass(frozen=True)
class WindowReport:
    """Closed-window output: the diagnosis plus raw window accounting."""

    diagnosis: Diagnosis
    steps: int
    durations: np.ndarray        # [N, R, S] (closed window matrix)
    step_wall: np.ndarray        # [N, R]
    closure: ClosureReport
    window_index: int
    closed_reason: str           # "full" | "schema_change" | "flush" | ...
    #: cumulative count of steps the aggregator has DISCARDED since
    #: construction (schema/world-size breaks drop the mismatched step
    #: that triggered the close).  Data loss is bounded but must be
    #: observable: a growing value across reports tells the operator the
    #: emitter's schema is flapping.
    dropped_steps: int = 0


class WindowAggregator:
    """Bounded streaming aggregator; never raises into the training loop."""

    def __init__(
        self,
        schema: StageSchema,
        *,
        window_steps: int = 100,
        gates: LabelerGates | None = None,
        max_pending_reports: int = 16,
        on_report: Callable[[WindowReport], None] | None = None,
    ):
        if window_steps < 1:
            raise ValueError("window_steps must be >= 1")
        self.schema = schema
        self.window_steps = window_steps
        self.gates = gates or LabelerGates()
        self._rows: list[np.ndarray] = []
        self._walls: list[np.ndarray] = []
        self._events: list[tuple[float, float]] = []  # (device_ms, cpu_ms)
        self._event_attempts = 0
        self._gather_ok = True
        self._present: set[int] = set(range(schema.world_size))
        self._window_index = 0
        self._reports: deque[WindowReport] = deque(maxlen=max_pending_reports)
        self._on_report = on_report
        self._model_fit: dict[str, int] = {}
        self._accum_collapsed = False
        #: steps discarded on contract breaks (observable data loss; the
        #: closing WindowReport snapshots it, see `add_step`).
        self.dropped_steps = 0

    # -- feeding -------------------------------------------------------------

    def add_step(
        self,
        durations: np.ndarray,
        step_wall: np.ndarray | float,
        *,
        gather_ok: bool = True,
        present_ranks: Iterable[int] | None = None,
    ) -> WindowReport | None:
        """Add one step's [R, S] matrix; returns a report if a window closed."""
        d = np.asarray(durations, dtype=np.float64)
        if d.ndim == 1:
            d = d[None]
        report: WindowReport | None = None
        if d.shape != (self.schema.world_size, self.schema.num_stages):
            # World-size / schema break: close what we have.  The
            # mismatched step cannot be folded into any window under this
            # schema, so it is discarded — but never silently: it counts
            # into `dropped_steps` *before* the close so the triggering
            # report (and every later one) carries the loss.
            self.dropped_steps += 1
            report = self._close("schema_change")
        else:
            w = np.asarray(step_wall, dtype=np.float64)
            if w.ndim == 0:
                w = np.full(d.shape[0], float(w))
            self._rows.append(d)
            self._walls.append(w)
            if not gather_ok:
                self._gather_ok = False
            if present_ranks is not None:
                self._present &= set(present_ranks)
            if len(self._rows) >= self.window_steps:
                report = self._close("full")
        return report

    def add_event_sample(self, device_ms: float | None, cpu_wall_ms: float) -> None:
        """Record one sampled device-time pair (None = not ready in time)."""
        self._event_attempts += 1
        if device_ms is not None:
            self._events.append((float(device_ms), float(cpu_wall_ms)))

    def set_model_fit(self, indicator: dict[str, int]) -> None:
        self._model_fit = dict(indicator)

    def mark_accumulation_collapsed(self) -> None:
        self._accum_collapsed = True

    def flush(self) -> WindowReport | None:
        return self._close("flush")

    # -- reports --------------------------------------------------------------

    @property
    def reports(self) -> tuple[WindowReport, ...]:
        return tuple(self._reports)

    def last_report(self) -> WindowReport | None:
        return self._reports[-1] if self._reports else None

    # -- internal --------------------------------------------------------------

    def _close(self, reason: str) -> WindowReport | None:
        if not self._rows:
            self._reset()
            return None
        d = np.stack(self._rows)            # [N, R, S]
        w = np.stack(self._walls)           # [N, R]
        closed, closure = close_residual(d, w, self.schema)
        event = None
        if self._event_attempts:
            ready = len(self._events)
            event = EventSummary(
                samples=ready,
                ready_ratio=ready / self._event_attempts,
                mean_device_ms=float(np.mean([e[0] for e in self._events])) if ready else 0.0,
                mean_cpu_wall_ms=float(np.mean([e[1] for e in self._events])) if ready else 0.0,
                stage=(
                    "model.fwd_loss_cpu_wall"
                    if "model.fwd_loss_cpu_wall" in self.schema.stages
                    else self.schema.stages[min(2, self.schema.num_stages - 1)]
                ),
            )
        diag = diagnose(
            closed,
            self.schema,
            gates=self.gates,
            closure=closure,
            gather_ok=self._gather_ok,
            present_ranks=sorted(self._present),
            event=event,
            model_fit=self._model_fit,
            accumulation_collapsed=self._accum_collapsed,
        )
        report = WindowReport(
            diagnosis=diag,
            steps=len(self._rows),
            durations=closed,
            step_wall=w,
            closure=closure,
            window_index=self._window_index,
            closed_reason=reason,
            dropped_steps=self.dropped_steps,
        )
        self._reports.append(report)
        self._window_index += 1
        self._reset()
        if self._on_report is not None:
            try:
                self._on_report(report)
            except Exception:
                pass  # monitoring callbacks must never fail the loop
        return report

    def _reset(self) -> None:
        self._rows.clear()
        self._walls.clear()
        self._events.clear()
        self._event_attempts = 0
        self._gather_ok = True
        self._present = set(range(self.schema.world_size))
        self._accum_collapsed = False
