"""What a run measured, handed to each metric's reader
(``stagebench/metrics/<metric>.py``, a function ``read(run)`` that
returns the metric's value, or None where it finds nothing to read)."""
from __future__ import annotations

import dataclasses

__all__ = ["RunRecord"]


@dataclasses.dataclass
class RunRecord:
    cell: str
    config: dict
    traffic: dict
    #: steps completed inside the measured window, and the tokens of each
    steps: int
    tokens_per_step: int
    #: the window's wall (host clock, from after warm-up to the
    #: synchronize that ends it)
    window_s: float
    #: process start to the first timed step
    setup_s: float
    #: ``torch.cuda.max_memory_allocated()`` over the window
    peak_bytes: int
    #: the recorder's records of the window's steps (stage name ->
    #: seconds in ``durations``; ``wall``)
    step_records: list
    #: the monitor's gather-and-label seconds inside the window, and the
    #: windows it closed there
    monitor_seconds: float
    monitor_windows: int
    #: model FLOPs of a step (`stagebench.flops`) and the card's peak in
    #: the compute type (`stagebench/peaks.json`; None for a card not in it)
    flops_per_step: float
    peak_flops: float | None
    #: the traced run's `trace.reduce_events`, plus ``steps`` traced
    trace: dict | None = None
