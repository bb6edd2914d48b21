"""Minimal telemetry contract (paper §3, Appendix A).

Ordered, residual-closed, clock-independent distributed stage vectors.

A *schema* fixes the ordered list of frontier stages for a diagnosis group.
Frontier accounting requires a common ordered boundary list within each
group: a stage may be broad but must be a contiguous, non-overlapping
interval.  The contract distinguishes

  - ordered frontier stages  (in the prefix vector),
  - side-channel probes      (nested, never in the prefix vector),
  - refined ordered schemas  (substages that replace a broad parent).

Violations never raise into training code; they produce `ContractReport`s
that the window manager converts into conservative downgrades (Table 11).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Stage taxonomies
# ---------------------------------------------------------------------------

#: Paper default broad taxonomy (Table 10) — "segmented" JAX mode, where
#: forward/loss, backward(grad) and optimizer-apply are separate jitted calls.
SEGMENTED_STAGES: tuple[str, ...] = (
    "data.next_wait",
    "model.fwd_loss_cpu_wall",
    "model.backward_cpu_wall",
    "callbacks.cpu_wall",
    "optim.step_cpu_wall",
    "step.other_cpu_wall",
)

#: Fused-step taxonomy for the JAX production default (one jitted train_step;
#: device time becomes host-visible at the metrics fetch).  See DESIGN.md §3.
FUSED_STAGES: tuple[str, ...] = (
    "data.next_wait",
    "step.dispatch_cpu_wall",
    "step.device_wait_cpu_wall",
    "callbacks.cpu_wall",
    "ckpt.cpu_wall",
    "step.other_cpu_wall",
)

#: The residual stage absorbing closure error; by contract it is always the
#: final ordered stage of any schema.
RESIDUAL_STAGE_SUFFIX = "other_cpu_wall"


@dataclasses.dataclass(frozen=True)
class StageSchema:
    """Ordered frontier-stage list plus metadata identifying a diagnosis group.

    ``schema_hash`` commits to the ordered names, version and world size, so
    mismatched rows are never merged (Table 11: close window, emit
    telemetry_limited).
    """

    stages: tuple[str, ...]
    version: str = "1"
    world_size: int = 1
    #: role tag per rank ("" = homogeneous).  Role-aware grouping splits the
    #: frontier per role; a global frontier across mixed roles is unsafe.
    roles: tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.stages) < 2:
            raise ValueError("schema needs >= 2 ordered stages")
        if len(set(self.stages)) != len(self.stages):
            raise ValueError(f"duplicate stage names: {self.stages}")
        if self.world_size < 1:
            raise ValueError("world_size must be >= 1")
        if self.roles and len(self.roles) != self.world_size:
            raise ValueError("roles must be empty or world_size long")

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def residual_index(self) -> int | None:
        for i, s in enumerate(self.stages):
            if s.endswith(RESIDUAL_STAGE_SUFFIX):
                return i
        return None

    @property
    def schema_hash(self) -> str:
        payload = "|".join(
            (self.version, str(self.world_size)) + self.stages
        ).encode()
        return hashlib.sha256(payload).hexdigest()[:16]

    @property
    def homogeneous(self) -> bool:
        return not self.roles or len(set(self.roles)) == 1

    def role_groups(self) -> dict[str, list[int]]:
        """Rank indices grouped by role ('' for all if homogeneous)."""
        if not self.roles:
            return {"": list(range(self.world_size))}
        groups: dict[str, list[int]] = {}
        for r, role in enumerate(self.roles):
            groups.setdefault(role, []).append(r)
        return groups

    def with_world_size(self, world_size: int, roles: Sequence[str] = ()) -> "StageSchema":
        return dataclasses.replace(self, world_size=world_size, roles=tuple(roles))

    def index(self, stage: str) -> int:
        return self.stages.index(stage)


def segmented_schema(world_size: int = 1, roles: Sequence[str] = ()) -> StageSchema:
    return StageSchema(SEGMENTED_STAGES, world_size=world_size, roles=tuple(roles))


def fused_schema(world_size: int = 1, roles: Sequence[str] = ()) -> StageSchema:
    return StageSchema(FUSED_STAGES, world_size=world_size, roles=tuple(roles))


# ---------------------------------------------------------------------------
# Closure / overlap accounting (Appendix A)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClosureReport:
    """Signed closure error per (step, rank).

    e[t,r]  = w[t,r] - sum_{s != other} d[t,r,s]
    residual d[t,r,other] = max(0, e)      (absorbed into the ordered vector)
    overlap  o[t,r]       = max(0, -e)     (nested/double-counted spans)
    """

    residual: np.ndarray  # [N, R] >= 0
    overlap: np.ndarray  # [N, R] >= 0
    residual_share: float  # sum residual / sum step wall
    overlap_share: float

    def ok(self, residual_gate: float = 0.05, overlap_gate: float = 0.01) -> bool:
        return (
            self.residual_share <= residual_gate
            and self.overlap_share <= overlap_gate
        )


def close_residual(
    durations: np.ndarray,
    step_wall: np.ndarray,
    schema: StageSchema,
) -> tuple[np.ndarray, ClosureReport]:
    """Fill the residual stage from measured step wall time.

    Args:
      durations: [N, R, S] nonneg stage durations with the residual column
        as-measured (typically zero).
      step_wall: [N, R] measured rank-local step wall time.

    Returns (closed durations, ClosureReport).
    """
    d = np.asarray(durations, dtype=np.float64).copy()
    w = np.asarray(step_wall, dtype=np.float64)
    if d.ndim != 3:
        raise ValueError(f"durations must be [N,R,S], got {d.shape}")
    n, r, s = d.shape
    if w.shape != (n, r):
        raise ValueError(f"step_wall must be [N,R]={n, r}, got {w.shape}")
    if s != schema.num_stages:
        raise ValueError(
            f"durations last dim {s} != schema stages {schema.num_stages}"
        )
    ri = schema.residual_index
    if ri is None:
        # No residual stage: report closure error but leave d unchanged.
        e = w - d.sum(axis=-1)
    else:
        explicit = d.sum(axis=-1) - d[..., ri]
        e = w - explicit
        d[..., ri] = np.maximum(0.0, e)
    residual = np.maximum(0.0, e)
    overlap = np.maximum(0.0, -e)
    denom = max(float(w.sum()), 1e-30)
    report = ClosureReport(
        residual=residual,
        overlap=overlap,
        residual_share=float(residual.sum()) / denom,
        overlap_share=float(overlap.sum()) / denom,
    )
    return d, report


# ---------------------------------------------------------------------------
# Contract validation (Table 11)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ContractReport:
    """Outcome of validating a window's rank-stage matrix against a schema."""

    valid: bool
    #: reasons keyed by check name; empty when valid.
    violations: tuple[str, ...] = ()
    #: ranks missing at the window boundary (downgrade distributed labels).
    missing_ranks: tuple[int, ...] = ()
    #: True when the matrix is usable for local (non-distributed) summaries.
    local_usable: bool = True


def validate_window(
    durations: np.ndarray,
    schema: StageSchema,
    *,
    schema_hashes: Sequence[str] | None = None,
    present_ranks: Sequence[int] | None = None,
) -> ContractReport:
    """Validate a [N, R, S] window matrix against the ordered-stage contract.

    Checks (Table 11):
      - shape agreement with the schema (mixed world sizes close the window),
      - a single schema hash inside the diagnosis group,
      - all ranks present at the window boundary,
      - nonnegative, finite durations (rank-local monotonic timing).
    """
    violations: list[str] = []
    d = np.asarray(durations)
    if d.ndim != 3:
        return ContractReport(False, ("shape: durations must be [N,R,S]",), local_usable=False)
    n, r, s = d.shape
    if s != schema.num_stages:
        violations.append(f"schema: stage count {s} != {schema.num_stages}")
    if r != schema.world_size:
        violations.append(f"world: rank count {r} != {schema.world_size}")
    if schema_hashes is not None and len(set(schema_hashes)) > 1:
        violations.append(f"schema: mixed hashes {sorted(set(schema_hashes))}")
    if not np.all(np.isfinite(d)):
        violations.append("timing: non-finite durations")
    elif np.any(d < 0):
        violations.append("timing: negative durations (non-monotonic clock)")
    missing: tuple[int, ...] = ()
    if present_ranks is not None:
        missing = tuple(sorted(set(range(schema.world_size)) - set(present_ranks)))
        if missing:
            violations.append(f"gather: missing ranks {missing}")
    local_usable = not any(v.startswith(("shape", "timing")) for v in violations)
    return ContractReport(
        valid=not violations,
        violations=tuple(violations),
        missing_ranks=missing,
        local_usable=local_usable,
    )
