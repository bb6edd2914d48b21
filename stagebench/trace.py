"""The device's side of a traced window, from `torch.profiler`'s events.

Busy time is the union of the device's activity intervals (kernels,
copies, sets) inside the window, so work that overlaps on two streams
counts once; idle time is the window less that union.  Each idle gap is
named by the loop's stage span (``stage:<name>``, `loop.TrainLoop`)
open on the host at the gap's midpoint, ``outside stages`` where none
is.  The window is the ``stagebench.window`` annotation the harness
opens around its timed steps.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

__all__ = ["WINDOW", "reduce_events"]

WINDOW = "stagebench.window"
_TOP = 10


def reduce_events(events) -> dict | None:
    """``{"busy_s", "window_s", "launches", "device_ops", "idle_gaps"}``
    from the profiler's kineto events, or None without the window
    annotation or any device event in it."""
    window = None
    stages = []
    device = []
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type().name == "CPU":
            name = e.name()
            if name == WINDOW:
                window = (start, end)
            elif name.startswith("stage:"):
                stages.append((start, end, name[len("stage:"):]))
        elif e.duration_ns() > 0 and not e.name().startswith(("stage:", WINDOW)):
            # the host's annotations are mirrored on the device's timeline:
            # they are not device work
            device.append((start, end, e.name()))
    if window is None:
        return None
    w0, w1 = window
    inside = sorted((max(s, w0), min(e, w1), n) for s, e, n in device if s < w1 and e > w0)
    if not inside:
        return None
    merged: list[list[int]] = []
    by_name: dict[str, int] = defaultdict(int)
    for s, e, n in inside:
        by_name[n] += e - s
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    stages.sort()
    starts = [s for s, _, _ in stages]

    def stage_at(t: int) -> str:
        # the spans are ordered and never overlap: the last one to start
        # before t holds it, or none does
        i = bisect.bisect_right(starts, t) - 1
        return stages[i][2] if i >= 0 and t < stages[i][1] else "outside stages"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:_TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "launches": len(inside),
        "device_ops": [[n[:160], t / 1e9] for n, t in ops],
        "idle_gaps": [[stage_at((a + b) // 2), (b - a) / 1e9] for a, b in longest],
    }
