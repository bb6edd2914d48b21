"""The timed loop: the program's train step inside the monitor's stages.

The benchmark's copy of the loop of `repro_torch.launch.train` (that
driver runs a number of steps, not a duration): each step takes its
batch from the prefetch pipeline and stages it on the device
(``data.next_wait``), dispatches the step and a copy of its loss to
pinned host memory behind it (``step.dispatch_cpu_wall``), then waits
for the previous step's loss (``step.device_wait_cpu_wall``), so the
host runs one step ahead of the device and the loop is closed;
``callbacks.cpu_wall`` and ``ckpt.cpu_wall`` are empty (no logging, no
checkpoint), and ``end_of_step`` folds the step into the monitor's
windows.  With `spans`, each stage is also a `torch.profiler`
annotation named ``stage:<stage>``, which names the device's idle gaps
in a traced run.
"""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

__all__ = ["TrainLoop"]

STAGES = ("data.next_wait", "step.dispatch_cpu_wall", "step.device_wait_cpu_wall",
          "callbacks.cpu_wall", "ckpt.cpu_wall")


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _HostLoss:
    """A step's loss on its way to the host: a pinned copy behind the
    step's work and an event after it (on the CPU, the loss itself)."""

    def __init__(self, loss: torch.Tensor):
        self.event = None
        if loss.is_cuda:
            self.host = torch.empty((), dtype=loss.dtype, pin_memory=True)
            self.host.copy_(loss, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = loss

    @property
    def handle(self):
        return self.host if self.event is None else self.event

    def value(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return float(self.host)


class TrainLoop:
    """Steps of `step_fn` over `state`, fed by `pipeline`, recorded by
    `monitor`.  ``losses[i]`` is step i's loss, read one step later."""

    def __init__(self, step_fn, state, monitor, pipeline, device, *, spans: bool = False):
        self.step_fn = step_fn
        self.state = state
        self.monitor = monitor
        self.pipeline = pipeline
        self.device = torch.device(device)
        self.spans = spans
        self.losses: list[float] = []
        self.steps = 0
        self._pending: _HostLoss | None = None

    def _stage(self, name: str):
        stage = self.monitor.stage(name)
        if not self.spans:
            return stage
        stack = contextlib.ExitStack()
        stack.enter_context(torch.profiler.record_function("stage:" + name))
        stack.enter_context(stage)
        return stack

    def _span(self, name: str):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function("stage:" + name)

    def step(self) -> None:
        mon = self.monitor
        with mon.step():
            with self._stage("data.next_wait"):
                host = next(self.pipeline)
                batch = {k: _to_device(v, self.device) for k, v in host.items()}
            t0 = time.perf_counter()
            with self._stage("step.dispatch_cpu_wall"):
                self.state, metrics = self.step_fn(self.state, batch)
                loss = _HostLoss(metrics["loss"])
            mon.observe_output(loss.handle, (time.perf_counter() - t0) * 1e3)
            with self._stage("step.device_wait_cpu_wall"):
                if self._pending is not None:
                    self.losses.append(self._pending.value())
                self._pending = loss
            with self._stage("callbacks.cpu_wall"):
                pass
            with self._stage("ckpt.cpu_wall"):
                pass
        with self._span("end_of_step"):
            mon.end_of_step()
        self.steps += 1

    def drain(self) -> None:
        """Read the last step's loss (the device has then finished it)."""
        if self._pending is not None:
            self.losses.append(self._pending.value())
            self._pending = None

    def failed(self, start: int) -> int:
        """Steps from `start` on whose loss is not finite."""
        return sum(not math.isfinite(x) for x in self.losses[start:])
