"""The trace reduction on made-up profiler events."""
from __future__ import annotations

import types

from stagebench.trace import WINDOW, reduce_events


def _event(name, start, duration, device):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: duration,
        device_type=lambda: types.SimpleNamespace(name=device))


def test_union_launches_and_named_gaps():
    events = [
        _event(WINDOW, 0, 1000, "CPU"),
        _event("stage:step.dispatch_cpu_wall", 0, 400, "CPU"),
        _event("stage:step.device_wait_cpu_wall", 400, 600, "CPU"),
        _event("gemm", 100, 200, "CUDA"),     # 100-300
        _event("softmax", 250, 100, "CUDA"),  # 250-350, overlaps
        _event("gemm", 700, 100, "CUDA"),     # 700-800
        _event("late", 990, 50, "CUDA"),      # clipped to 990-1000
        _event("stage:step.dispatch_cpu_wall", 0, 400, "CUDA"),  # a mirrored annotation
        _event(WINDOW, 0, 1000, "CUDA"),
    ]
    out = reduce_events(events)
    assert out["window_s"] == 1000 / 1e9
    assert out["busy_s"] == (250 + 100 + 10) / 1e9
    assert out["launches"] == 4
    assert out["device_ops"][0] == ["gemm", 300 / 1e9]
    gaps = dict((round(s * 1e9), n) for n, s in out["idle_gaps"])
    assert gaps == {350: "step.device_wait_cpu_wall", 190: "step.device_wait_cpu_wall",
                    100: "step.dispatch_cpu_wall"}


def test_no_window_reads_nothing():
    assert reduce_events([_event("gemm", 0, 10, "CUDA")]) is None
