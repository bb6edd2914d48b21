"""Device-timed regions of the train step, kept in the recorder's side
channel.

The program marks where each region of its step begins and ends
(`enter` / `exit` on the tensor that flows in and out, `region` around
code with no tensor to carry, `recomputing` around code that only a
checkpoint's recompute should mark); at each boundary the timer records one
CUDA event with timing, taken from a pool and reused.  Each interval
between consecutive boundaries is charged to the region on top of a
stack of open regions, or to ``none`` when the stack is empty, so the
regions tile the step's device span exactly and nested regions never
count twice.  A region's time is the stream's elapsed time between its
boundaries, idle included.

Regions: ``embed``, ``attention``, ``ssm``, ``ssm_scan`` (the SSD's
chunked scan, nested in ``ssm``), ``moe``, ``mlp``, ``head_loss`` (each
in phases ``fwd``, ``recompute`` and ``bwd``) and ``optimizer`` (one
phase).  A forward boundary is an identity
`torch.autograd.Function` whose backward marks the matching backward
boundary in reverse order; it saves no tensor, so numbers do not change.
A forward boundary that fires while the autograd engine runs a backward
is the ``recompute`` of a `torch.utils.checkpoint` (`checkpoint` closes
the regions a recompute leaves open when it stops early).  An `enter`
marker must take the tensor before every use of it in the step, so that
gradients are summed in the same order with the regions on and off.

The regions are on for a step that `Monitor.step()` opens while a
`torch.profiler` trace records, or inside `timed_regions()`; the check
runs once a step.  Off, every marker site costs one test of the
module-level `timer` and nothing enters the autograd graph.

Each step's intervals are folded into its `StepRecord.side`, in seconds:
``region.<name>.<phase>`` (``region.optimizer``), ``region.none`` and
``region.step``, the span from the first boundary to the last.  A step
is folded once its last event reads complete (`RegionTimer.poll`, at
`Monitor.end_of_step`, never blocking), or when its side channel is
first read (the events are then complete, as after a synchronize).
Each boundary also keeps its host time on the profiler's clock
(`time.time_ns`), so a region can be placed on a `torch.profiler`
trace; on the CPU, where ops run as they are called, that host time is
the boundary's time.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

__all__ = ["RegionTimer", "checkpoint", "enter", "exit", "recomputing", "region",
           "timed_regions", "timer", "wanted"]

#: the timer of the step in progress whose regions are on, else None
timer: "RegionTimer | None" = None
_forced = 0


@contextlib.contextmanager
def timed_regions():
    """Turn the regions on, without a profiler, for the steps opened
    inside (an operator's view; measuring what the regions cost)."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def wanted() -> bool:
    """Whether a step opened now times its regions."""
    return _forced > 0 or torch.autograd.profiler._is_profiler_enabled


def enter(name: str, x: torch.Tensor) -> torch.Tensor:
    """`x` as region `name` begins (a view of it while the regions are on)."""
    if timer is None:
        return x
    return _Boundary.apply(x, timer, name, True)


def exit(name: str, x: torch.Tensor) -> torch.Tensor:  # noqa: A001
    """`x` as region `name` ends."""
    if timer is None:
        return x
    return _Boundary.apply(x, timer, name, False)


def region(name: str):
    """Region `name` around code that carries no tensor through it (the
    optimizer: one phase, no backward)."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.span(name)


def recomputing(name: str):
    """Region `name`'s recompute phase around code that a checkpoint
    re-runs inside a backward (the attention's query blocks, inside the
    attention's backward); nothing in the forward, nor where the region
    is recomputing already (the layer's re-run)."""
    if timer is None or torch._C._current_autograd_node() is None:
        return contextlib.nullcontext()
    return timer.span(name, phase="recompute")


def checkpoint(fn, *args, **kwargs):
    """`torch.utils.checkpoint.checkpoint` (non-reentrant), whose
    recompute closes the regions it opened when it ends: a recompute
    stops once it has rebuilt the last saved tensor, which may fall
    before a region's exit marker."""
    if timer is not None:
        kwargs["context_fn"] = timer.contexts
    return _checkpoint(fn, *args, **kwargs)


class _Boundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, owner, name, entering):
        ctx.owner, ctx.name, ctx.entering = owner, name, entering
        recompute = torch._C._current_autograd_node() is not None
        owner.forward_boundary(name, entering, "recompute" if recompute else "fwd", x)
        return x

    @staticmethod
    def backward(ctx, grad):
        ctx.owner.backward_boundary(ctx.name, ctx.entering)
        return grad, None, None, None


class _Step:
    """One step's boundaries: (event or None, host ns, the region the
    interval after it is charged to: (name, phase) or None)."""

    __slots__ = ("record", "cuda", "bounds", "folded")

    def __init__(self):
        self.record = None
        self.cuda = None
        self.bounds: list = []
        self.folded = False

    def complete(self) -> bool:
        return not self.cuda or self.bounds[-1][0].query()


def _key(frame) -> str:
    if frame is None:
        return "region.none"
    name, phase = frame
    return f"region.{name}" if phase is None else f"region.{name}.{phase}"


class RegionTimer:
    """A `Monitor`'s region timer: the open step's stack of regions and
    boundaries, the steps not folded yet, and the pool of events."""

    def __init__(self, recorder):
        self.recorder = recorder
        #: a list while an operator keeps each folded step's intervals
        #: (`launch.train`'s heavy trace), else None
        self.log: list | None = None
        self._stack: list = []
        self._step: _Step | None = None
        self._pending: deque[_Step] = deque()
        self._pool: list = []

    # -- the step ------------------------------------------------------------------

    def begin_step(self) -> bool:
        """Open a step; its regions are on where `wanted()`.  Returns
        whether they are."""
        global timer
        if self._step is not None or not wanted():
            return False
        self._step = _Step()
        self._stack.clear()
        timer = self
        return True

    def end_step(self, record) -> None:
        """Close the open step, its intervals bound for `record` (a
        `StepRecord`): folded by `poll` or on the first read of its side."""
        global timer
        step, self._step = self._step, None
        if timer is self:
            timer = None
        self._stack.clear()
        if step is None or len(step.bounds) < 2:
            if step is not None:
                self._release(step)
            return
        step.record = record
        record.side.settle = lambda: self._fold(step)
        self._pending.append(step)

    def poll(self) -> None:
        """Fold, oldest first, each closed step whose last event has
        completed; never waits on the device."""
        while self._pending and (self._pending[0].folded or self._pending[0].complete()):
            self._fold(self._pending.popleft())

    def settle(self) -> None:
        """Fold every closed step, waiting for its events."""
        while self._pending:
            self._fold(self._pending.popleft())

    # -- boundaries ----------------------------------------------------------------

    def forward_boundary(self, name: str, entering: bool, phase: str, x) -> None:
        if entering:
            self._stack.append((name, phase))
        else:
            self._pop(name)
        self._mark(x)

    def backward_boundary(self, name: str, entering: bool) -> None:
        if entering:
            self._pop(name)
        else:
            self._stack.append((name, "bwd"))
        self._mark(None)

    @contextlib.contextmanager
    def span(self, name: str, phase: str | None = None):
        frame = (name, phase)
        if self._stack and self._stack[-1] == frame:
            yield
            return
        self._stack.append(frame)
        self._mark(None)
        try:
            yield
        finally:
            self._pop(name)
            self._mark(None)

    def contexts(self):
        """`checkpoint`'s ``context_fn``: nothing around the forward; the
        recompute closes what it left open."""
        return contextlib.nullcontext(), self._recompute()

    @contextlib.contextmanager
    def _recompute(self):
        depth = len(self._stack)
        try:
            yield
        finally:
            if len(self._stack) > depth:
                del self._stack[depth:]
                self._mark(None)

    def _pop(self, name: str) -> None:
        for i in range(len(self._stack) - 1, -1, -1):
            if self._stack[i][0] == name:
                del self._stack[i:]
                return

    def _mark(self, x) -> None:
        step = self._step
        if step is None:
            return
        if step.cuda is None:
            if x is None:
                return  # the step's first boundary, a marker's, names its device
            step.cuda = x.is_cuda
        event = None
        host = time.time_ns()
        if step.cuda:
            event = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
            event.record()
        step.bounds.append((event, host, self._stack[-1] if self._stack else None))

    # -- folding -------------------------------------------------------------------

    def _fold(self, step: _Step) -> None:
        if step.folded:
            return
        step.folded = True
        bounds = step.bounds
        if step.cuda:  # event ms; on the CPU whole host ns, so the sums are exact
            bounds[-1][0].synchronize()  # complete already where polled
            elapsed, seconds = (lambda a, b: a[0].elapsed_time(b[0])), 1e-3
        else:
            elapsed, seconds = (lambda a, b: b[1] - a[1]), 1e-9
        sums: dict = {}
        intervals = []
        for a, b in zip(bounds, bounds[1:]):
            key = _key(a[2])
            sums[key] = sums.get(key, 0) + elapsed(a, b)
            if self.log is not None:
                name, phase = a[2] if a[2] is not None else ("none", None)
                intervals.append({"region": name, "phase": phase, "host_start_ns": a[1],
                                  "device_ms": elapsed(a, b) * seconds * 1e3})
        sums["region.step"] = elapsed(bounds[0], bounds[-1])
        for key, ticks in sums.items():
            self.recorder.add_side_value(key, ticks * seconds, step.record)
        if self.log is not None:
            self.log.append({"step": step.record.step, "host_end_ns": bounds[-1][1],
                             "intervals": intervals})
        self._release(step)

    def _release(self, step: _Step) -> None:
        self._pool.extend(e for e, _, _ in step.bounds if e is not None)
        step.bounds = []
