"""StageFrontier monitor: the always-on integration used by the train loop.

Wires together the rank-local StageRecorder, the sampled device-time side
channel, the failure-safe window gather, the streaming WindowAggregator +
deterministic labeler, evidence packets, and the operational policy —
the full paper pipeline behind two calls:

    mon = Monitor(schema, rank=..., transport=...)
    with mon.step():
        with mon.stage("data.next_wait"): batch = next(it)
        ...
    report = mon.end_of_step(outputs)   # gathers/labels at window boundaries
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from ..core.contract import StageSchema
from ..core.labeler import LabelerGates
from ..core.windows import WindowAggregator, WindowReport
from ..distributed.policy import Action, MonitorPolicy
from .device_events import DeviceEventChannel
from .gather import GatherResult, TelemetryGather
from .packets import EvidencePacket, from_diagnosis
from .recorder import StageRecorder

__all__ = ["Monitor"]


class Monitor:
    """Per-process StageFrontier runtime (rank 0 also labels and routes)."""

    def __init__(
        self,
        schema: StageSchema,
        *,
        rank: int = 0,
        transport=None,
        window_steps: int = 100,
        event_q: float = 0.05,
        gates: LabelerGates | None = None,
        policy: MonitorPolicy | None = None,
        on_action: Callable[[Action], None] | None = None,
        keep_windows: bool = False,
    ):
        self.schema = schema
        self.rank = rank
        self.recorder = StageRecorder(schema)
        self.events = DeviceEventChannel(event_q)
        self.gatherer = (
            TelemetryGather(transport, rank) if transport is not None else None
        )
        self.aggregator = WindowAggregator(schema, window_steps=window_steps, gates=gates)
        self.policy = policy or MonitorPolicy()
        self.on_action = on_action
        self.window_steps = window_steps
        self.packets: list[EvidencePacket] = []
        self.actions: list[Action] = []
        self.keep_windows = keep_windows
        self._local_rows: list[np.ndarray] = []
        self._local_walls: list[float] = []
        self._step_t0 = 0.0
        #: cumulative seconds spent on gather+label (the overhead numerator).
        self.monitor_path_seconds = 0.0

    # -- recording ---------------------------------------------------------------

    def step(self):
        self._step_t0 = time.perf_counter()
        return self.recorder.step()

    def stage(self, name: str):
        return self.recorder.stage(name)

    def observe_output(self, output: Any, cpu_wall_ms: float) -> None:
        """Sampled device-time channel; call right after step dispatch.

        `output` is the step's handle: a `torch.cuda.Event` recorded on
        the current stream right after dispatch (a CPU tensor reads as
        ready at once)."""
        rec = self.recorder
        self.events.observe(rec._step_index, output, cpu_wall_ms)

    # -- window boundary ------------------------------------------------------------

    def end_of_step(self) -> WindowReport | None:
        """Fold the last recorded step; gathers + labels at window closes."""
        last = self.recorder.last()
        if last is None:
            return None
        self._local_rows.append(np.array(last.vector(self.schema)))
        self._local_walls.append(last.wall)
        for step, device_ms, cpu_ms in self.events.poll():
            self.aggregator.add_event_sample(device_ms, cpu_ms)
        if len(self._local_rows) < self.window_steps:
            return None
        t0 = time.perf_counter()
        local = np.stack(self._local_rows)           # [N, S]
        walls = np.array(self._local_walls)
        self._local_rows.clear()
        self._local_walls.clear()

        gather_ok = True
        present = None
        if self.gatherer is not None:
            result: GatherResult = self.gatherer.gather_window(local)
            gather_ok = result.ok
            present = result.present_ranks
            if result.ok:
                window = result.window
            else:
                # degraded: zero-fill missing ranks; present_ranks tells the
                # labeler to cap confidence (telemetry_limited), local rows
                # still support safe local summaries.
                r = self.schema.world_size
                window = np.zeros((local.shape[0], r, local.shape[1]))
                for rr, part in enumerate(result.parts or ()):
                    if part is not None and rr < r:
                        window[:, rr, :] = part
                if self.rank < r:
                    window[:, self.rank, :] = local
        else:
            window = local[:, None, :]               # single-process view

        report = None
        for i in range(window.shape[0]):
            report = self.aggregator.add_step(
                window[i],
                walls[i] if window.shape[1] == 1 else window[i].sum(-1),
                gather_ok=gather_ok,
                present_ranks=present,
            ) or report
        report = report or self.aggregator.flush()
        if report is not None:
            pkt = from_diagnosis(
                report.diagnosis,
                self.schema.stages,
                report.steps,
                window.shape[1],
                report.window_index,
                window=report.durations if self.keep_windows else None,
                present_ranks=tuple(present) if present is not None else (),
            )
            self.packets.append(pkt)
            acts = self.policy.on_report(report)
            self.actions.extend(acts)
            if self.on_action is not None:
                for a in acts:
                    try:
                        self.on_action(a)
                    except Exception:
                        pass  # monitoring never fails training
        self.monitor_path_seconds += time.perf_counter() - t0
        return report

    # -- summaries --------------------------------------------------------------------

    def overhead_fraction(self, train_seconds: float) -> float:
        """Gather-path time / training time (the paper's rho)."""
        return self.monitor_path_seconds / max(train_seconds, 1e-9)
