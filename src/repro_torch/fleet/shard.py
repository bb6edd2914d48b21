"""Stable job-id partition helpers of the sharded fleet tier.

`shard_of` and `job_id_for_shard` are the hash partition that a sharded
fleet service routes by; the simulator's shard-splitting scenarios use
them to place jobs.  The sharded coordinator itself
(`ShardedFleetService`) is not part of this package yet.
"""
from __future__ import annotations

import zlib

__all__ = ["job_id_for_shard", "shard_of"]


def shard_of(job_id: str, shards: int) -> int:
    """Owning shard of `job_id` among `shards` workers.

    Stable by construction (CRC-32 of the UTF-8 id — never Python's
    salted `hash`): the same job lands on the same shard across
    processes, restarts, and runs, so re-arrivals and duplicate windows
    keep hitting the registry state that knows them.
    """
    if shards <= 0:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return zlib.crc32(job_id.encode("utf-8")) % shards


def job_id_for_shard(
    base: str, shard: int, shards: int, *, sep: str = "~"
) -> str:
    """Deterministic job id derived from `base` that hashes to `shard`.

    Test/scenario helper (e.g. `sim.scenarios.shared_host_fleet`'s
    shard-splitting placement): returns `base` itself when it already
    lands on `shard`, else the first ``{base}{sep}{i}`` that does —
    deterministic, so fixtures and differential runs agree on ids.
    """
    if not 0 <= shard < shards:
        raise ValueError(f"shard {shard} outside [0, {shards})")
    if shard_of(base, shards) == shard:
        return base
    i = 0
    while True:
        cand = f"{base}{sep}{i}"
        if shard_of(cand, shards) == shard:
            return cand
        i += 1
