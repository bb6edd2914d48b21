"""StageFrontier core: the paper's contribution as a composable library.

Layers:
  contract      ordered-stage telemetry contract (schemas, closure, checks)
  frontier      max-prefix frontier accounting (Thm 1, slack identity)
  gain          clipped-baseline direct-exposure score (Eq. 4)
  evidence      leader / lag / tie / switch localization evidence
  labeler       deterministic evidence-scoped diagnosis labels (Tables 12-13)
  baselines     comparison stage-attribution rules (paper §6.2)
  routing       compact candidate routing sets (tau_C prefix)
  accumulation  gradient-accumulation ordered-substage expansion
  windows       bounded streaming window aggregation
  streaming     incremental one-step-at-a-time frontier engine (fleet path)
  whatif        counterfactual per-(stage, rank) recoverable-time matrix
  regimes       temporal regime segmentation (transient/recurring/persistent)
"""
from .contract import (
    FUSED_STAGES,
    SEGMENTED_STAGES,
    ClosureReport,
    ContractReport,
    StageSchema,
    close_residual,
    fused_schema,
    segmented_schema,
    validate_window,
)
from .frontier import (
    FrontierResult,
    advances_via_slack,
    frontier_accounting,
    frontier_advances,
    per_stage_average_total,
    per_stage_max_total,
    slack,
    window_shares,
)
from .gain import (
    all_stage_gains,
    cohort_median_baseline,
    direct_exposure_gain,
    per_rank_median_baseline,
)
from .evidence import LeaderEvidence, leader_evidence
from .labeler import (
    ALL_LABELS,
    CO_CRITICAL,
    DIRECT_EXPOSURE,
    FRONTIER_ACCOUNTING,
    GRADIENT_ACCUMULATION_AMBIGUOUS,
    LIKELY_SYNC_WAIT,
    ROLE_AWARE_NEEDED,
    SYNC_WAIT_DEPENDENT,
    TELEMETRY_LIMITED,
    Diagnosis,
    EventSummary,
    LabelerGates,
    diagnose,
)
from .labeler import diagnose_grouped
from .baselines import BASELINE_RULES, stage_scores
from .routing import RoutingSet, candidate_set, score_routing
from .accumulation import (
    aggregate_advances,
    expand_matrix,
    expand_schema,
    semantic_groups,
)
from .regimes import (
    NONE,
    PERSISTENT,
    RECURRING,
    REGIME_NAMES,
    TRANSIENT,
    RegimeCall,
    RegimeParams,
    RegimeResult,
    RegimeSegment,
    RegimeStats,
    classify,
    excess_stream,
    persistence_weight,
    regime_stats,
    segment_regimes,
    segment_stream,
)
from .streaming import (
    StreamingFrontier,
    StreamingRegimes,
    StreamingWhatIf,
    StreamingWindowState,
)
from .whatif import (
    Intervention,
    WhatIfResult,
    imputed_work,
    make_sync_mask,
    step_contributions,
    top_interventions,
    whatif_matrix,
    whatif_matrix_naive,
)
from .windows import WindowAggregator, WindowReport

__all__ = [k for k in dir() if not k.startswith("_")]
