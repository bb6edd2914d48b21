"""The monitor's window accounting, worked out again in NumPy.

For one rank, the frontier of a window is each step's stage durations
laid end to end: the residual stage (the schema's last, ``*other_cpu_wall``)
takes what the step's wall leaves over the explicit stages (never less
than nothing), a stage's share is its summed time over the window's
summed step time, and the routing set is the smallest run of stages, in
descending share (the lower index first on a tie), whose shares reach
tau = 0.8 (the paper's candidate threshold).
"""
from __future__ import annotations

import numpy as np

__all__ = ["TAU", "window_accounting"]

TAU = 0.8


def window_accounting(rows: list[tuple[dict, float]], stages: tuple[str, ...],
                      window_steps: int) -> list[dict]:
    """Each whole window of `rows` (a step's ``{stage: seconds}`` and its
    wall, in order) as ``{"shares": [...], "routing": [stage names]}``."""
    out = []
    for start in range(0, len(rows) - window_steps + 1, window_steps):
        d = np.zeros((window_steps, len(stages)))
        for t, (durations, wall) in enumerate(rows[start:start + window_steps]):
            explicit = [durations.get(s, 0.0) for s in stages[:-1]]
            d[t, :-1] = explicit
            d[t, -1] = max(0.0, wall - sum(explicit))
        total = d.sum()
        shares = d.sum(axis=0) / total if total > 0 else np.zeros(len(stages))
        routing, reached = [], 0.0
        if total > 0:
            for i in sorted(range(len(stages)), key=lambda i: (-shares[i], i)):
                routing.append(stages[i])
                reached += shares[i]
                if reached >= TAU - 1e-12:
                    break
        out.append({"shares": [float(x) for x in shares], "routing": routing})
    return out
