"""Always-on stage recorder (paper §5): `perf.step()` / `perf.stage()`.

CPU wall-clock (`time.perf_counter_ns`) stage spans with:
  - ordered-stage non-overlap enforcement (nested ordered spans rejected;
    nested measurements allowed only as side channels),
  - residual closure (step wall minus explicit spans -> step.other),
  - prefetch-aware data alignment: a `data.next_wait` recorded before the
    first compute span of step t is charged to step t (the consuming step),
  - bounded history (always-on means bounded queues),
  - zero hot-path device synchronization.

The recorder is rank-local; the window aggregation and gather live in
repro.telemetry.collector / repro.core.windows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Iterator

from ..core.contract import StageSchema

__all__ = ["SideValues", "StageRecorder", "StepRecord"]


def _now_s() -> float:
    return time.perf_counter_ns() * 1e-9


class SideValues(dict):
    """A step's side channel.  A measurement that settles after its step
    has closed (device time, `regions.RegionTimer`) sets `settle`, which
    the first read through the mapping's methods calls to fold it in."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.settle = None

    def _settled(self) -> "SideValues":
        settle, self.settle = self.settle, None
        if settle is not None:
            settle()
        return self


def _reading(name: str):
    method = getattr(dict, name)

    def read(self, *args, **kwargs):
        return method(self._settled(), *args, **kwargs)

    read.__name__ = name
    return read


for _name in ("__getitem__", "__contains__", "__iter__", "__len__", "__repr__", "__eq__",
              "__ne__", "get", "keys", "values", "items", "copy"):
    setattr(SideValues, _name, _reading(_name))


@dataclasses.dataclass
class StepRecord:
    """One step's ordered stage durations + metadata."""

    step: int
    durations: dict[str, float]           # ordered stage name -> seconds
    wall: float                           # step wall time (seconds)
    side: dict[str, float] = dataclasses.field(default_factory=dict)

    def vector(self, schema: StageSchema) -> list[float]:
        return [self.durations.get(s, 0.0) for s in schema.stages]


class StageRecorder:
    """Rank-local ordered-stage timing with contract enforcement."""

    def __init__(self, schema: StageSchema, *, max_history: int = 4096):
        self.schema = schema
        self._history: deque[StepRecord] = deque(maxlen=max_history)
        self._step_index = 0
        self._in_step = False
        self._active_stage: str | None = None
        self._cur: dict[str, float] = {}
        self._side: dict[str, float] = {}
        self._step_start = 0.0
        #: a data wait measured outside a step is charged to the NEXT step
        #: (the consuming one) — prefetch-aware alignment.
        self._pending_data_wait = 0.0
        self.dropped_spans = 0

    # -- step context -----------------------------------------------------------

    @property
    def in_step(self) -> bool:
        """True between `begin_step()` and `end_step()` (public span API:
        service-side instrumentation checks this before opening a step
        lazily — see `repro.obs.ObsTickline`)."""
        return self._in_step

    @property
    def active_stage(self) -> str | None:
        """Name of the currently open ordered span, or None.  Lets a
        caller detect re-entrancy (a nested service call inside an
        instrumented phase) and skip instead of violating non-overlap."""
        return self._active_stage

    def begin_step(self) -> bool:
        """Open a step span manually; returns False (and counts the
        dropped span) if one is already open.  The manual lifecycle is
        the span API `repro.obs` needs: a service tick's phases span
        several method calls, so the step cannot be a single `with`."""
        if self._in_step:  # nested steps are a contract violation: drop inner
            self.dropped_spans += 1
            return False
        self._in_step = True
        self._cur = {}
        self._side = {}
        self._step_start = _now_s()
        if self._pending_data_wait:
            self._cur["data.next_wait"] = self._pending_data_wait
            self._pending_data_wait = 0.0
        return True

    def end_step(self) -> StepRecord | None:
        """Close the open step span: residual closure, history append.
        Returns the finished record (None if no step was open)."""
        if not self._in_step:
            return None
        wall = _now_s() - self._step_start
        explicit = sum(
            v for k, v in self._cur.items()
            if k in self.schema.stages and not k.endswith("other_cpu_wall")
        )
        residual = self.schema.residual_index
        if residual is not None:
            self._cur[self.schema.stages[residual]] = max(0.0, wall - explicit)
        record = StepRecord(
            step=self._step_index,
            durations=dict(self._cur),
            wall=wall,
            side=SideValues(self._side),
        )
        self._history.append(record)
        self._step_index += 1
        self._in_step = False
        self._active_stage = None
        return record

    @contextlib.contextmanager
    def step(self) -> Iterator["StageRecorder"]:
        opened = self.begin_step()
        try:
            yield self
        finally:
            if opened:
                self.end_step()

    # -- stage contexts ------------------------------------------------------------

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Ordered frontier stage. Nested ordered spans are rejected
        (recorded as dropped, never raised into training)."""
        if self._active_stage is not None or not self._in_step:
            if name == "data.next_wait" and not self._in_step:
                # prefetch path: charge to the consuming step
                t0 = _now_s()
                try:
                    yield
                finally:
                    self._pending_data_wait += _now_s() - t0
                return
            self.dropped_spans += 1
            yield
            return
        if name not in self.schema.stages:
            self.dropped_spans += 1
            yield
            return
        self._active_stage = name
        t0 = _now_s()
        try:
            yield
        finally:
            self._cur[name] = self._cur.get(name, 0.0) + (_now_s() - t0)
            self._active_stage = None

    @contextlib.contextmanager
    def side_channel(self, name: str) -> Iterator[None]:
        """Nested measurement allowed anywhere; never enters the prefix
        vector (side_channel=true in the contract)."""
        t0 = _now_s()
        try:
            yield
        finally:
            self._side[name] = self._side.get(name, 0.0) + (_now_s() - t0)

    def add_side_value(self, name: str, value: float,
                       record: StepRecord | None = None) -> None:
        """Add `value` to side channel `name` of the open step, or of the
        closed step `record` (a measurement that settles after its step,
        as device time does)."""
        side = self._side if record is None else record.side
        side[name] = side.get(name, 0.0) + float(value)

    # -- history ---------------------------------------------------------------------

    @property
    def history(self) -> tuple[StepRecord, ...]:
        return tuple(self._history)

    def last(self) -> StepRecord | None:
        return self._history[-1] if self._history else None

    def drain(self) -> list[StepRecord]:
        out = list(self._history)
        self._history.clear()
        return out
