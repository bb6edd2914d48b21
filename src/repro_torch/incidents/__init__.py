"""incidents — persistent cross-job fault tracking (the incident tier).

The fleet service re-derives "where to aim the profiler" from scratch
every window; this tier gives that answer *identity, lifecycle, and a
budget*.  Route entries become durable `Incident` objects
(open -> active -> merged -> cooling -> resolved), the same fault
re-surfacing across windows dedups onto one incident, faults appearing
in >= 2 jobs on one host promote to a fleet-level common-cause incident
(`Topology` join + the co-activation kernel), and a token-bucket
`EscalationController` turns the ranked incidents into at most B
profiler attachments per tick, with hysteresis.

Layers:
  topology    the tiered rank -> host -> switch -> pod placement map
              (static, or learned from SFP2-v2/v3 packets' placement
              sections)
  engine      incident identity, lifecycle, exposure accumulation,
              cross-job promotion to the narrowest explaining tier
  escalation  budgeted, hysteretic profiler-attachment planning (fleet
              before job, wider tier before narrower)
"""
from .engine import (
    ACTIVE,
    COOLING,
    CorrelationGroup,
    Incident,
    IncidentEngine,
    IncidentParams,
    LIVE_STATES,
    MERGED,
    OPEN,
    RESOLVED,
    TIER_RANK,
    activity_meta,
    fold_host_activity,
)
from .escalation import EscalationController, ProfilerAction
from .topology import TIERS, Topology

__all__ = [
    "ACTIVE",
    "COOLING",
    "CorrelationGroup",
    "EscalationController",
    "Incident",
    "IncidentEngine",
    "IncidentParams",
    "LIVE_STATES",
    "MERGED",
    "OPEN",
    "ProfilerAction",
    "RESOLVED",
    "TIERS",
    "TIER_RANK",
    "Topology",
    "activity_meta",
    "fold_host_activity",
]
