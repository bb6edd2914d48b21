"""Packet types and the torch prolog of the fleet tick.

The counterparts of the reference package's `kernels/frontier/ops.py`
pieces that the fused tick needs: the per-job packet NamedTuples (now of
torch tensors) and the cheap prolog reductions that feed the kernel —
the sync-imputed work, the per-job cohort median baselines, and the
per-(step, stage) what-if boundary statistics.

Layout: the natural [J, N, R, S] window layout throughout.  Stage
prefixes are explicit adds in the reference's order (`stage_prefix`),
never `torch.cumsum`: the CUDA kernel rebuilds every rank's boundary
arrival with the same adds,
so the leader's own arrival equals the prolog's `amax` bit for bit and
its zero-excess cell gains no spurious recoverable seconds.

Subnormals: the reference flushes every float32 value below FLT_MIN in
magnitude to zero, inputs and results alike (XLA's CPU runtime and the
TPU both run with flush-to-zero), and the CUDA kernel is built with
``-ftz=true``.  The torch code around the kernel does the same by its
own hand: `ftz` after every float operation that can make a subnormal,
so the plain version flushes on any device and under no process flag.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.whatif import sync_segments

__all__ = [
    "CoActivationPacket",
    "FleetPacket",
    "FleetRegimePacket",
    "FleetWhatIfPacket",
    "fleet_median_baseline",
    "ftz",
    "imputed_work",
    "stage_prefix",
    "whatif_stats",
]

#: "never active" onset sentinel and the leader index of no rank
BIG_IDX = 2**30

_FLT_MIN = torch.finfo(torch.float32).tiny


def ftz(t: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to a zero of the same sign, as a
    flush-to-zero unit does with an operand or a result; everything else
    (normals, zeros, infinities, NaNs) passes unchanged."""
    return torch.where(t.abs() < _FLT_MIN, t * 0.0, t)


class FleetPacket(NamedTuple):
    """Per-job evidence packets for a stacked fleet tensor d[J, N, R, S]."""

    frontier: torch.Tensor   # [J, N, S]
    advances: torch.Tensor   # [J, N, S]
    leader: torch.Tensor     # [J, N, S] i32
    gap: torch.Tensor        # [J, N, S]
    exposed: torch.Tensor    # [J, N]
    shares: torch.Tensor     # [J, S]   Eq. 2 per job
    gains: torch.Tensor      # [J, S]   Eq. 4 per job


class FleetWhatIfPacket(NamedTuple):
    """Per-job what-if matrices for a stacked fleet tensor d[J, N, R, S]."""

    matrix: torch.Tensor     # [J, S, R]
    exposed: torch.Tensor    # [J, N]


class FleetRegimePacket(NamedTuple):
    """Per-job regime statistics ([J, S, R] each) for d[J, N, R, S]."""

    count: torch.Tensor          # i32 active steps
    onset: torch.Tensor          # i32 first active step, -1 = never
    last: torch.Tensor           # i32 last active step, -1 = never
    runs: torch.Tensor           # i32 distinct bursts
    streak: torch.Tensor         # i32 trailing active streak
    sum_excess: torch.Tensor     # f32 sum_t e[t]
    sum_prefix: torch.Tensor     # f32 C = sum_t A_t (running sums)
    duty: torch.Tensor           # f32 active fraction since onset
    slope: torch.Tensor          # f32 excess trend, seconds/step


class CoActivationPacket(NamedTuple):
    """Cross-job co-activation statistics, [S, H] (i32 each)."""

    jobs: torch.Tensor      # distinct jobs with any activation
    coact: torch.Tensor     # steps with >= 2 jobs active at once
    active: torch.Tensor    # total active job-steps


#: stages per block of the stage prefix (see `stage_prefix`)
_PREFIX_BLOCK = 16


def stage_prefix(x: torch.Tensor) -> torch.Tensor:
    """Prefix over the last (stage) axis, in the reference's add order.

    Up to 16 stages: explicit stage-ordered adds, P[0] = x[0],
    P[s] = P[s-1] + x[s].  Past that, the order of XLA's cumulative sum
    (which the reference's `jnp.cumsum` runs): the stages split into
    blocks of 16, each block takes the ordered prefix of its own stages,
    and block b > 0 adds the prefix, taken by this same rule, of the
    totals of blocks 0 .. b-1.  The CUDA kernel walks the stages in this
    order too.
    """
    s = x.shape[-1]
    if s <= _PREFIX_BLOCK:
        cols = [x[..., 0]]
        for i in range(1, s):
            cols.append(ftz(cols[-1] + x[..., i]))
        return torch.stack(cols, dim=-1)
    nb = -(-s // _PREFIX_BLOCK)
    pad = torch.zeros(x.shape[:-1] + (nb * _PREFIX_BLOCK - s,),
                      dtype=x.dtype, device=x.device)
    blocks = torch.cat([x, pad], dim=-1).unflatten(-1, (nb, _PREFIX_BLOCK))
    local = stage_prefix(blocks)                          # [..., nb, 16]
    totals = stage_prefix(local[..., -1])                 # [..., nb]
    out = torch.cat([
        local[..., :1, :],
        ftz(totals[..., :-1, None] + local[..., 1:, :]),
    ], dim=-2)
    return out.flatten(-2)[..., :s]


def fleet_median_baseline(x: torch.Tensor) -> torch.Tensor:
    """Per-job cohort median [J, S] over the N*R samples of each stage.

    The midpoint median of `jnp.median`: (v[(n-1)//2] + v[n//2]) * 0.5 of
    the sorted samples.  `torch.median` returns the lower middle value
    instead, which differs whenever N*R is even.
    """
    jn, n, r, s = x.shape
    v = torch.sort(x.reshape(jn, n * r, s), dim=1).values
    m = n * r
    return ftz(ftz(v[:, (m - 1) // 2] + v[:, m // 2]) * 0.5)


def imputed_work(
    d: torch.Tensor, sync_stages: tuple[int, ...], wmin: torch.Tensor | None
) -> torch.Tensor:
    """Counterpart of `core.whatif.imputed_work` on [J, N, R, S]: sync
    stages take the per-step cross-rank minimum `wmin` [J, N, S] (the
    only wait-free observation a coarse stage vector holds)."""
    if not sync_stages:
        return d
    mask = torch.zeros(d.shape[-1], dtype=torch.bool, device=d.device)
    mask[list(sync_stages)] = True
    return torch.where(mask, wmin[:, :, None, :], d)


def whatif_stats(
    w: torch.Tensor, sync_stages: tuple[int, ...]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(step, stage) governing-boundary stats of the imputed work.

    For each sync segment, replays the arrivals at its boundary
    (previous release + segment prefix) and reduces them across ranks to
    (max, second, leader); every stage carries its own segment's stats.
    Returns four [J, N, S] tensors: amax, second (-inf when R == 1),
    leader (i32, the lowest rank on ties) and relprev.
    """
    jn, n, r, s = w.shape
    p = stage_prefix(w)
    ranks = torch.arange(r, device=w.device, dtype=torch.int32)
    relbase = torch.zeros((jn, n), dtype=w.dtype, device=w.device)
    amax_cols, sec_cols, lead_cols, relp_cols = [], [], [], []
    for start, end in sync_segments(sync_stages, s):
        seg = ftz(p[..., end] - p[..., start - 1]) if start else p[..., end]
        arr = ftz(relbase[:, :, None] + seg)                  # [J, N, R]
        amax = arr.amax(dim=2)
        lead = torch.where(
            arr == amax[:, :, None], ranks, BIG_IDX
        ).amin(dim=2).to(torch.int32)
        second = torch.where(
            ranks == lead[:, :, None], float("-inf"), arr
        ).amax(dim=2)
        for _ in range(start, end + 1):
            amax_cols.append(amax)
            sec_cols.append(second)
            lead_cols.append(lead)
            relp_cols.append(relbase)
        relbase = amax
    return (
        torch.stack(amax_cols, dim=-1),
        torch.stack(sec_cols, dim=-1),
        torch.stack(lead_cols, dim=-1),
        torch.stack(relp_cols, dim=-1),
    )
