"""Deterministic diagnosis labeler (paper §4, Appendices B-C).

The labeler is deterministic given the stage matrix, schema metadata,
optional side evidence and threshold configuration: it validates the
ordered-stage contract and schema/world membership, computes prefixes,
frontier advances, shares and the routing set, computes lag / delta-lag /
tie / leader-switch evidence and clipped direct-exposure gain, applies
telemetry-quality and role-aware gates, evaluates optional device-time or
communication side evidence, and emits labels, the routing set, the
ambiguity evidence set, and downgrade reasons.

Labels (Table 12) describe orthogonal evidence axes, not a flat confidence
ladder.  The safe default model-fit indicator is W_s = 0: do not infer
sync-wait dependence without workload or side evidence.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .contract import ClosureReport, ContractReport, StageSchema, validate_window
from .evidence import LeaderEvidence, leader_evidence
from .frontier import FrontierResult, frontier_accounting
from .gain import all_stage_gains, cohort_median_baseline
from .routing import RoutingSet, candidate_set

# ---------------------------------------------------------------------------
# Label constants (Table 12)
# ---------------------------------------------------------------------------

FRONTIER_ACCOUNTING = "frontier_accounting"
LIKELY_SYNC_WAIT = "likely_sync_wait"
SYNC_WAIT_DEPENDENT = "sync_wait_dependent"
DIRECT_EXPOSURE = "direct_exposure"
FORWARD_DEVICE_SUPPORTED = "forward_device_supported"
FORWARD_SPILLOVER_SUSPECTED = "forward_spillover_suspected"
FORWARD_HOST_OVERHEAD_SUSPECTED = "forward_host_overhead_suspected"
FORWARD_EVENT_SCOPE_LIMITED = "forward_event_scope_limited"
CO_CRITICAL = "co_critical"
GRADIENT_ACCUMULATION_AMBIGUOUS = "gradient_accumulation_ambiguous"
ROLE_AWARE_NEEDED = "role_aware_needed"
TELEMETRY_LIMITED = "telemetry_limited"

ALL_LABELS = (
    FRONTIER_ACCOUNTING,
    LIKELY_SYNC_WAIT,
    SYNC_WAIT_DEPENDENT,
    DIRECT_EXPOSURE,
    FORWARD_DEVICE_SUPPORTED,
    FORWARD_SPILLOVER_SUSPECTED,
    FORWARD_HOST_OVERHEAD_SUSPECTED,
    FORWARD_EVENT_SCOPE_LIMITED,
    CO_CRITICAL,
    GRADIENT_ACCUMULATION_AMBIGUOUS,
    ROLE_AWARE_NEEDED,
    TELEMETRY_LIMITED,
)


@dataclasses.dataclass(frozen=True)
class LabelerGates:
    """Default labeler gates (Table 13) — conservative starting points."""

    closure_residual_share: float = 0.05
    overlap_error_share: float = 0.01
    missing_rank_count: int = 0
    event_ready_ratio: float = 0.8
    min_event_samples: int = 5
    gamma_a: float = 0.4          # frontier-share dominance
    gamma_g: float = 0.1          # static-gain threshold
    eta_a: float = 0.05           # share tie tolerance
    eta_g: float = 0.05           # gain tie tolerance
    eta_q: float = 0.05           # leader tie tolerance (fraction of exposed)
    gamma_switch: float = 0.25    # max confident-leader switch rate
    gamma_elig: float = 0.02      # confident-lead gap fraction
    tau_c: float = 0.80           # candidate cumulative threshold
    #: window-denominator floor (seconds of summed exposed makespan) below
    #: which percentages are suppressed and raw advances reported.
    denominator_floor: float = 1e-6


@dataclasses.dataclass(frozen=True)
class EventSummary:
    """Sampled device-time side channel summary (never in the prefix vector).

    JAX adaptation of the paper's CUDA-event channel: ``mean_device_ms`` is
    the sampled dispatch->ready latency of the forward/loss (or fused-step)
    region; ``ready_ratio`` is the fraction of sampled pairs that completed.
    """

    samples: int
    ready_ratio: float
    mean_device_ms: float
    mean_cpu_wall_ms: float
    #: which ordered stage the event channel is side evidence for.
    stage: str = "model.fwd_loss_cpu_wall"


@dataclasses.dataclass(frozen=True)
class Diagnosis:
    """Machine-readable labeler output for one window."""

    labels: tuple[str, ...]
    routing: RoutingSet
    routing_stages: tuple[str, ...]      # names, descending score
    shares: tuple[float, ...]            # A_s per stage
    gains: tuple[float, ...]             # G_s per stage
    co_critical_stages: tuple[str, ...]  # ambiguity set E_amb (names)
    downgrade_reasons: tuple[str, ...]
    leader: LeaderEvidence | None
    #: raw advances are authoritative when the denominator floor was hit.
    raw_advances: tuple[float, ...]
    exposed_makespan_total: float
    gather_ok: bool
    schema_hash: str

    def has(self, label: str) -> bool:
        return label in self.labels


def _topset(scores: np.ndarray, eta: float) -> set[int]:
    """Indices within eta of the max score (the near-tie set)."""
    if scores.size == 0:
        return set()
    m = float(scores.max())
    return {int(i) for i in np.nonzero(scores >= m - eta)[0]}


def diagnose(
    durations: np.ndarray,
    schema: StageSchema,
    *,
    gates: LabelerGates | None = None,
    closure: ClosureReport | None = None,
    gather_ok: bool = True,
    present_ranks: Sequence[int] | None = None,
    schema_hashes: Sequence[str] | None = None,
    event: EventSummary | None = None,
    #: caller-supplied model-fit indicator W_s per stage (default all 0:
    #: never infer sync-wait dependence without workload/side evidence).
    model_fit: Mapping[str, int] | None = None,
    accumulation_collapsed: bool = False,
    #: optional explicit no-stall reference for the clipped gain (Eq. 4);
    #: default is the cohort (cross-rank) median, which exposes hidden-rank
    #: tails that a per-rank median would absorb.
    gain_baseline: np.ndarray | None = None,
) -> Diagnosis:
    """Run the full deterministic labeling pipeline on one window."""
    g = gates or LabelerGates()
    d = np.asarray(durations, dtype=np.float64)
    if d.ndim == 2:
        d = d[None]

    labels: set[str] = set()
    reasons: list[str] = []

    # ---- contract / telemetry-quality gates -------------------------------
    contract = validate_window(
        d, schema, schema_hashes=schema_hashes, present_ranks=present_ranks
    )
    telemetry_ok = True
    if not contract.valid:
        reasons.extend(contract.violations)
        if not contract.local_usable:
            # Vector unusable even for local accounting.
            return Diagnosis(
                labels=(TELEMETRY_LIMITED,),
                routing=candidate_set(np.zeros(schema.num_stages), g.tau_c),
                routing_stages=(),
                shares=tuple(0.0 for _ in schema.stages),
                gains=tuple(0.0 for _ in schema.stages),
                co_critical_stages=(),
                downgrade_reasons=tuple(reasons),
                leader=None,
                raw_advances=tuple(0.0 for _ in schema.stages),
                exposed_makespan_total=0.0,
                gather_ok=gather_ok,
                schema_hash=schema.schema_hash,
            )
        telemetry_ok = False
    if not gather_ok:
        telemetry_ok = False
        reasons.append("gather: gather_ok=false")
    if len(contract.missing_ranks) > g.missing_rank_count:
        telemetry_ok = False
    if closure is not None and not closure.ok(
        g.closure_residual_share, g.overlap_error_share
    ):
        telemetry_ok = False
        reasons.append(
            "closure: residual_share="
            f"{closure.residual_share:.4f} overlap_share={closure.overlap_share:.4f}"
        )

    # ---- accounting (always the base claim when the vector is usable) -----
    result = frontier_accounting(d)
    labels.add(FRONTIER_ACCOUNTING)
    shares = result.shares()
    advances_total = result.advances.sum(axis=0)
    exposed_total = float(result.exposed_makespan.sum())
    below_floor = exposed_total < g.denominator_floor
    if below_floor:
        reasons.append("denominator: below window floor; raw advances emitted")

    if gain_baseline is None:
        gain_baseline = cohort_median_baseline(d)
    gains = all_stage_gains(d, gain_baseline)
    # Straggler identity is evaluated at the top-share stage's boundary:
    # post-sync boundaries are structurally tied across ranks.
    top_stage = int(np.argmax(result.advances.sum(axis=0)))
    lead = leader_evidence(
        result, stage=top_stage, eta_q=g.eta_q, gamma_elig=g.gamma_elig
    )

    routing = candidate_set(advances_total, g.tau_c)
    routing_stages = tuple(schema.stages[i] for i in routing.stages)

    # ---- role-aware gate ---------------------------------------------------
    if not schema.homogeneous:
        labels.add(ROLE_AWARE_NEEDED)
        reasons.append(
            f"roles: heterogeneous role set {sorted(set(schema.roles))}; "
            "global rank aggregation is unsafe"
        )

    if not telemetry_ok:
        labels.add(TELEMETRY_LIMITED)

    if accumulation_collapsed:
        labels.add(GRADIENT_ACCUMULATION_AMBIGUOUS)
        reasons.append("accumulation: microsteps collapsed or mixed")

    # ---- single-rank edge: no cross-rank evidence --------------------------
    single_rank = d.shape[1] < 2

    # ---- strong stage labels (suppressed on telemetry/role problems) ------
    strong_ok = (
        telemetry_ok
        and schema.homogeneous
        and not below_floor
        and not single_rank
    )
    w = dict(model_fit or {})

    c_a = _topset(shares, g.eta_a)
    c_g = _topset(gains, g.eta_g)
    e_amb = sorted(c_a | c_g)
    s1 = int(np.argmax(shares)) if shares.size else 0
    a1 = float(shares[s1]) if shares.size else 0.0
    g1 = float(gains[s1]) if gains.size else 0.0
    near_tie = len(c_a) > 1
    switchy = (
        lead.eligible_share > 0
        and lead.switches / max(1, result.num_steps - 1) > g.gamma_switch
    )

    if strong_ok and a1 > g.gamma_a:
        if near_tie or switchy:
            labels.add(CO_CRITICAL)
            if near_tie:
                reasons.append(f"tie: shares within eta_a at stages {sorted(c_a)}")
            if switchy:
                reasons.append(
                    f"leader: {lead.switches} switches over {result.num_steps} steps"
                )
        elif g1 >= g.gamma_g:
            labels.add(DIRECT_EXPOSURE)
        else:
            # High share, low clipped static gain: actionability depends on
            # the wait model.  W=1 -> sync_wait_dependent (and, with strong
            # leader evidence, likely_sync_wait); W=0 -> co_critical.
            if w.get(schema.stages[s1], 0) == 1:
                labels.add(SYNC_WAIT_DEPENDENT)
                if lead.leader_rank >= 0 and lead.leader_share >= 0.5:
                    labels.add(LIKELY_SYNC_WAIT)
            else:
                labels.add(CO_CRITICAL)
                reasons.append(
                    f"gain: A[{schema.stages[s1]}]={a1:.3f} but "
                    f"G={g1:.3f} < gamma_g with W=0"
                )
    elif strong_ok:
        # No dominant stage: co-critical only if several stages share load.
        if near_tie and a1 > 0:
            labels.add(CO_CRITICAL)
            reasons.append(f"tie: no dominant stage, near-tied {sorted(c_a)}")

    # ---- device-time side-channel labels (orthogonal axis) ----------------
    if event is not None:
        scope_ok = (
            event.samples >= g.min_event_samples
            and event.ready_ratio >= g.event_ready_ratio
        )
        if not scope_ok:
            labels.add(FORWARD_EVENT_SCOPE_LIMITED)
            reasons.append(
                f"event: samples={event.samples} ready={event.ready_ratio:.2f}"
            )
        else:
            cpu, dev = event.mean_cpu_wall_ms, event.mean_device_ms
            if dev >= 0.5 * max(cpu, 1e-9):
                # Device time explains the span.
                try:
                    ev_idx = schema.index(event.stage)
                except ValueError:
                    ev_idx = -1
                if ev_idx >= 0 and ev_idx in c_a:
                    labels.add(FORWARD_DEVICE_SUPPORTED)
                elif dev > cpu * 1.5:
                    # Device work outlives its host span: exposed later,
                    # usually in the following (backward/device-wait) stage.
                    labels.add(FORWARD_SPILLOVER_SUSPECTED)
                else:
                    labels.add(FORWARD_DEVICE_SUPPORTED)
            elif cpu > 2.0 * max(dev, 1e-9):
                labels.add(FORWARD_HOST_OVERHEAD_SUSPECTED)

    co_stages = tuple(schema.stages[i] for i in e_amb) if CO_CRITICAL in labels else ()

    return Diagnosis(
        labels=tuple(sorted(labels)),
        routing=routing,
        routing_stages=routing_stages,
        shares=tuple(float(x) for x in shares),
        gains=tuple(float(x) for x in gains),
        co_critical_stages=co_stages,
        downgrade_reasons=tuple(reasons),
        leader=lead,
        raw_advances=tuple(float(x) for x in advances_total),
        exposed_makespan_total=exposed_total,
        gather_ok=gather_ok,
        schema_hash=schema.schema_hash,
    )


def diagnose_grouped(
    durations: np.ndarray,
    schema: StageSchema,
    **kwargs,
) -> dict[str, Diagnosis]:
    """Role-aware grouped diagnosis (Table 11 upgrade path).

    When rank roles differ (pipeline stages, encoder/decoder splits, ...) a
    global frontier is unsafe (`role_aware_needed`); with role metadata the
    frontier is exact *within* each role group, because the sync-wait
    exposure model's homogeneity assumption holds per group.  Returns one
    Diagnosis per role, each computed over that role's rank slice with a
    role-restricted schema.
    """
    d = np.asarray(durations, dtype=np.float64)
    if d.ndim == 2:
        d = d[None]
    out: dict[str, Diagnosis] = {}
    for role, ranks in schema.role_groups().items():
        sub_schema = StageSchema(
            stages=schema.stages,
            version=f"{schema.version}+role:{role or 'all'}",
            world_size=len(ranks),
        )
        sub_kwargs = dict(kwargs)
        pr = sub_kwargs.pop("present_ranks", None)
        if pr is not None:
            index = {r: i for i, r in enumerate(ranks)}
            sub_kwargs["present_ranks"] = [index[r] for r in pr if r in index]
        out[role or "all"] = diagnose(d[:, ranks, :], sub_schema, **sub_kwargs)
    return out
