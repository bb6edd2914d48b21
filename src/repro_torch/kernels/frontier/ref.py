"""Plain-torch oracles of the frontier, what-if and regime kernels.

The counterparts of the reference package's `kernels/frontier/ref.py`
jnp oracles.  For a window tensor d[N, R, S] (durations, nonnegative):

  frontier[t, s]   = max_r P[t, r, s],  P the stage prefix of d
  advances[t, s]   = frontier[t, s] - frontier[t, s-1]
  leader[t, s]     = the lowest rank holding the max
  second[t, s]     = the top-2 second over ranks (= max when tied; -inf R=1)
  clipped[t, s]    = max_r (P[t, r, S-1] - max(0, d[t,r,s] - b[t,r,s]))

(the final-prefix shift identity: clipping d[:, :, s] to b lowers every
rank's final prefix by exactly the excess), the what-if matrix by its
per-segment top-2 shift identity, and the regime statistics of the
thresholded exposed-increment streams.

They are written per window and share no code with the kernels' plain
versions beyond the numerical helpers that fix the reference's order:
every stage prefix is `ops.stage_prefix` (never `torch.cumsum`), every
step sum an explicit step-ordered add chain, and `ops.ftz` follows every
float operation, so each oracle equals its kernel route bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.regimes import RegimeParams as _RegimeParams
from ...core.whatif import sync_segments
from .ops import ftz, stage_prefix

__all__ = [
    "FrontierWindow",
    "RegimeWindow",
    "frontier_window_ref",
    "regime_segments_ref",
    "whatif_matrix_ref",
]

_REGIME_DEFAULTS = _RegimeParams()


class FrontierWindow(NamedTuple):
    frontier: torch.Tensor       # [N, S] f32
    advances: torch.Tensor       # [N, S] f32
    leader: torch.Tensor         # [N, S] i32
    second: torch.Tensor         # [N, S] f32 (-inf when R == 1)
    clipped: torch.Tensor        # [N, S] f32 (Eq. 4 numerator input)


class RegimeWindow(NamedTuple):
    """Per-candidate temporal statistics of one window, [S, R] each."""

    count: torch.Tensor          # i32 active steps
    onset: torch.Tensor          # i32 first active step, -1 = never
    last: torch.Tensor           # i32 last active step, -1 = never
    runs: torch.Tensor           # i32 distinct active bursts
    streak: torch.Tensor         # i32 trailing consecutive active steps
    sum_excess: torch.Tensor     # f32 sum_t e[t]
    sum_prefix: torch.Tensor     # f32 C = sum_t A_t, A_t = sum_{u<=t} e[u]


def _f32(x) -> torch.Tensor:
    """`x` as a flushed float32 tensor (subnormal inputs read as zero)."""
    return ftz(torch.as_tensor(x).to(torch.float32))


def _imputed(d: torch.Tensor, syncs: tuple[int, ...]) -> torch.Tensor:
    """Sync stages take the per-step cross-rank minimum of d[N, R, S]."""
    if not syncs:
        return d
    mask = torch.zeros(d.shape[-1], dtype=torch.bool, device=d.device)
    mask[list(syncs)] = True
    return torch.where(mask, d.amin(dim=1, keepdim=True), d)


def _second(x: torch.Tensor, lead: torch.Tensor, dim: int) -> torch.Tensor:
    """Max of `x` along `dim` with exactly the leader's entry masked
    (tied duplicates of the max stay; -inf when the axis has one entry)."""
    idx = torch.arange(x.shape[dim], device=x.device)
    shape = [1] * x.dim()
    shape[dim] = -1
    mask = idx.view(shape) == lead.unsqueeze(dim)
    return torch.where(mask, float("-inf"), x).amax(dim=dim)


def frontier_window_ref(d, baseline) -> FrontierWindow:
    """Oracle.  d, baseline: [N, R, S] (baseline broadcastable); any
    float dtype (computes in float32)."""
    d = _f32(d)
    b = _f32(baseline).to(d.device).broadcast_to(d.shape)
    prefix = stage_prefix(d)                             # [N, R, S]
    frontier = prefix.amax(dim=1)                        # [N, S]
    leader = prefix.argmax(dim=1)                        # first on ties
    advances = ftz(torch.diff(frontier, dim=1,
                              prepend=torch.zeros_like(frontier[:, :1])))
    second = _second(prefix, leader, dim=1)
    excess = torch.clamp_min(ftz(d - b), 0.0)
    clipped = ftz(prefix[:, :, -1:] - excess).amax(dim=1)
    return FrontierWindow(frontier, advances, leader.to(torch.int32), second,
                          clipped)


def regime_segments_ref(
    d,
    baseline,
    *,
    min_excess_s: float = _REGIME_DEFAULTS.min_excess_s,
    rel_excess: float = _REGIME_DEFAULTS.rel_excess,
    sync_stages: tuple[int, ...] | None = None,
) -> RegimeWindow:
    """Oracle of the regime-statistics route.

    Thresholds the per-(stage, rank) exposed-increment streams
    ``e = max(0, w - b)`` (w the sync-imputed work, b the [R, S]
    reference) into activity series and reduces each candidate's series
    to the statistics `core.regimes.regime_stats` defines.  The two float
    sums are explicit step-ordered add chains with no multiplies, as the
    reference's oracle and the kernel's fold; the t-weighted excess sum
    the trend slope needs is n*sum_excess - sum_prefix.
    """
    d = _f32(d)
    n, r, s = d.shape
    syncs = tuple(sorted({int(i) for i in (sync_stages or ())}))
    w = _imputed(d, syncs)
    b = _f32(baseline).to(d.device).broadcast_to((r, s))
    e = torch.clamp_min(ftz(w - b[None]), 0.0)           # [N, R, S]
    thr = ftz(torch.clamp_min(ftz(float(rel_excess) * b), float(min_excess_s)))
    act = e > thr[None]
    acti = act.to(torch.int32)

    count = acti.sum(dim=0, dtype=torch.int32)           # [R, S]
    any_ = count > 0
    onset = torch.where(any_, acti.argmax(dim=0), -1)    # first active step
    last = torch.where(any_, n - 1 - acti.flip(0).argmax(dim=0), -1)
    prev = torch.cat([torch.zeros_like(act[:1]), act[:-1]], dim=0)
    runs = (act & ~prev).sum(dim=0, dtype=torch.int32)
    streak = torch.cumprod(acti.flip(0), dim=0).sum(dim=0, dtype=torch.int32)
    sum_e, sum_pfx = e[0], e[0]
    for t in range(1, n):
        sum_e = ftz(sum_e + e[t])
        sum_pfx = ftz(sum_pfx + sum_e)
    return RegimeWindow(
        count=count.T,
        onset=onset.to(torch.int32).T,
        last=last.to(torch.int32).T,
        runs=runs.T,
        streak=streak.T,
        sum_excess=sum_e.T,
        sum_prefix=sum_pfx.T,
    )


def whatif_matrix_ref(
    d, baseline, sync_stages: tuple[int, ...] | None = None
) -> torch.Tensor:
    """Oracle of the counterfactual what-if route: W[S, R] seconds.

    W[s, r] = sum_t (M[t] - M^{(s,r)<-b}[t]): clip ONE (stage, rank) cell
    of the (imputed) work to the baseline and replay the step makespan
    under the declared sync model.  Per rank, the shift identity applies
    at the candidate's governing boundary (the first declared barrier at
    or after its stage, or the window end): only rank r's arrival there
    drops, by excess = max(0, w - b), so the counterfactual release is
    max(max over the OTHER ranks' arrivals, rank r's shifted arrival), the
    "other" max being the boundary's top-2.  The steps sum in step order.
    """
    d = _f32(d)
    n, r, s = d.shape
    syncs = tuple(sorted({int(i) for i in (sync_stages or ())}))
    w = _imputed(d, syncs)
    b = _f32(baseline).to(d.device).broadcast_to(w.shape)
    excess = torch.clamp_min(ftz(w - b), 0.0)            # [N, R, S]
    prefix = stage_prefix(w)                             # [N, R, S]
    contrib = torch.zeros((n, r, s), dtype=torch.float32, device=d.device)
    relbase = torch.zeros(n, dtype=torch.float32, device=d.device)
    for start, end in sync_segments(syncs, s):
        seg = (ftz(prefix[:, :, end] - prefix[:, :, start - 1]) if start
               else prefix[:, :, end])
        arr = ftz(relbase[:, None] + seg)                # [N, R]
        amax = arr.amax(dim=1)                           # [N]
        lead = arr.argmax(dim=1)                         # first on ties
        other = torch.where(
            torch.arange(r, device=d.device)[None, :] == lead[:, None],
            _second(arr, lead, dim=1)[:, None],
            amax[:, None],
        )                                                # [N, R]
        e = excess[:, :, start:end + 1]
        new_a = torch.maximum(other[:, :, None], ftz(arr[:, :, None] - e))
        contrib[:, :, start:end + 1] = torch.clamp_min(
            ftz(amax[:, None, None] - new_a), 0.0
        )
        relbase = amax
    total = torch.zeros((r, s), dtype=torch.float32, device=d.device)
    for t in range(n):
        total = ftz(total + contrib[t])
    return total.T                                       # [S, R]
