"""Streaming multi-job aggregation (the fleet tier).

Layers:
  ingest     failure-safe wire decoding (SFP2 + legacy SFP1 framing;
             raw f64, int8, and int8 delta+varint payload codecs)
  registry   bounded per-job streaming state + liveness/eviction
  service    logical-clock service: submit / submit_many / tick /
             refresh_batched / route, the tick kernel on CUDA
  shard      N-shard scale-out: stable job-id hash partition behind a
             `ShardedFleetService` coordinator with the same API and
             bit-identical merged answers (routes, snapshots, incidents
             via the cross-shard activity reduce); one CUDA stream per
             shard
"""
from .ingest import FleetIngest, IngestStats
from .registry import FleetRegistry, JobState
from .service import FleetService, RouteEntry
from .shard import ShardedFleetService, job_id_for_shard, shard_of

__all__ = [
    "FleetIngest",
    "FleetRegistry",
    "FleetService",
    "IngestStats",
    "JobState",
    "RouteEntry",
    "ShardedFleetService",
    "job_id_for_shard",
    "shard_of",
]
