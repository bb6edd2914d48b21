"""Gradient-accumulation ordered-stage handling (paper §3, E7).

For accumulation factor m, the ordered stage list is expanded by
accumulation index *before* the frontier is taken, and semantic reporting
groups are aggregated only afterward, so repeated microsteps are not
collapsed prematurely.  Changed factors or sync patterns close the window
(handled by the window manager via the expanded schema hash).
"""
from __future__ import annotations

import numpy as np

from .contract import StageSchema

__all__ = [
    "expand_schema",
    "expand_matrix",
    "semantic_groups",
    "aggregate_advances",
]

#: stages that repeat per microstep under accumulation.
MICRO_STAGES = ("data.next_wait", "model.fwd_loss_cpu_wall", "model.backward_cpu_wall")


def expand_schema(schema: StageSchema, factor: int) -> StageSchema:
    """Expand micro-stages by accumulation index: data@0, fwd@0, bwd@0, data@1, ...

    Non-micro stages (callbacks, optimizer, residual) stay once, after the
    expanded microsteps, preserving execution order of a DDP-no_sync-style
    accumulation loop.
    """
    if factor < 1:
        raise ValueError("factor must be >= 1")
    if factor == 1:
        return schema
    micro = [s for s in schema.stages if s in MICRO_STAGES]
    tail = [s for s in schema.stages if s not in MICRO_STAGES]
    expanded: list[str] = []
    for i in range(factor):
        expanded.extend(f"{s}@{i}" for s in micro)
    expanded.extend(tail)
    return StageSchema(
        stages=tuple(expanded),
        version=f"{schema.version}+accum{factor}",
        world_size=schema.world_size,
        roles=schema.roles,
    )


def expand_matrix(micro_durations: np.ndarray, tail_durations: np.ndarray) -> np.ndarray:
    """Build the expanded [N, R, m*Sm + St] matrix from per-microstep spans.

    Args:
      micro_durations: [N, R, m, Sm] — per-microstep micro-stage durations.
      tail_durations:  [N, R, St]    — per-step tail-stage durations.
    """
    m = np.asarray(micro_durations, dtype=np.float64)
    t = np.asarray(tail_durations, dtype=np.float64)
    if m.ndim != 4 or t.ndim != 3:
        raise ValueError("micro [N,R,m,Sm], tail [N,R,St] expected")
    n, r = m.shape[:2]
    flat = m.reshape(n, r, -1)
    return np.concatenate([flat, t], axis=-1)


def semantic_groups(expanded: StageSchema) -> dict[str, list[int]]:
    """Map semantic stage name -> expanded column indices (data -> data@*)."""
    groups: dict[str, list[int]] = {}
    for i, name in enumerate(expanded.stages):
        base = name.split("@", 1)[0]
        groups.setdefault(base, []).append(i)
    return groups


def aggregate_advances(
    advances: np.ndarray, expanded: StageSchema
) -> tuple[np.ndarray, tuple[str, ...]]:
    """Aggregate expanded frontier advances back to semantic groups.

    This is the *after the frontier* aggregation: the frontier has already
    attributed exposed time at microstep granularity, so collapsing here is
    safe; collapsing before the frontier is the mistake the
    gradient_accumulation_ambiguous label flags.
    """
    a = np.asarray(advances, dtype=np.float64)
    groups = semantic_groups(expanded)
    names = tuple(groups.keys())
    out = np.zeros(a.shape[:-1] + (len(names),))
    for j, name in enumerate(names):
        out[..., j] = a[..., groups[name]].sum(axis=-1)
    return out, names
