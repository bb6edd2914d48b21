"""Trace-driven replay: cluster-trace-shaped workloads through the fleet.

The validation front end for `fleet`: a versioned JSONL trace
schema (`trace` — job arrival/resize/departure with Alibaba-taxonomy
task roles and per-job stage vocabularies, plus fault events carrying
injected ground truth), a deterministic synthetic-trace generator, and
a replay clock (`engine`) that drives the traced fleet through the
standard aggregate -> packetize -> wire -> `FleetService` path and
scores the routing answer against the trace's injected faults per
window.  `python -m repro_torch.launch.replay` is the CLI.
"""
from .engine import ReplayReport, replay_trace
from .trace import (
    FAULT_FAMILIES,
    SCORED_FAMILIES,
    TRACE_VERSION,
    Trace,
    TraceEvent,
    TraceStats,
    TraceTask,
    generate_trace,
    load_trace,
    parse_trace,
)

__all__ = [
    "FAULT_FAMILIES",
    "SCORED_FAMILIES",
    "TRACE_VERSION",
    "ReplayReport",
    "Trace",
    "TraceEvent",
    "TraceStats",
    "TraceTask",
    "generate_trace",
    "load_trace",
    "parse_trace",
    "replay_trace",
]
