"""Packet types, the torch prolog of the fleet tick and the kernel routes.

The counterpart of the reference package's `kernels/frontier/ops.py`:

  * the per-job packet NamedTuples (now of torch tensors), for the fleet
    ([J, ...]) and for one window (the J = 1 squeezes);
  * the prolog every kernel route shares (`tick_inputs`): the input as a
    flushed float32 tensor on its device, the sync-imputed work's
    cross-rank minimum, the per-job cohort median baselines, the what-if
    boundary statistics and the regime threshold;
  * the epilogs every route shares (`frontier_packet`, `regime_packet`);
  * the single-family routes of the four-dispatch reference path —
    `fleet_frontier_window`, `fleet_whatif_matrix`, `fleet_regime_stats`,
    each one launch of its kernel in `frontier.py` — with their J = 1
    squeezes, per-job loops and plain-torch oracle routes.

Layout: the natural [J, N, R, S] window layout throughout.  Stage
prefixes are explicit adds in the reference's order (`stage_prefix`),
never `torch.cumsum`: the CUDA kernels rebuild every rank's boundary
arrival with the same adds, so the leader's own arrival equals the
prolog's `amax` bit for bit and its zero-excess cell gains no spurious
recoverable seconds.

Subnormals: the reference flushes every float32 value below FLT_MIN in
magnitude to zero, inputs and results alike (XLA's CPU runtime and the
TPU both run with flush-to-zero), and the CUDA kernels are built with
``-ftz=true``.  The torch code around the kernels does the same by its
own hand: `ftz` after every float operation that can make a subnormal,
so the plain versions flush on any device and under no process flag.
"""
from __future__ import annotations

import pathlib
from typing import NamedTuple

import numpy as np
import torch

from ...core.regimes import RegimeParams as _RegimeParams
from ...core.whatif import sync_segments
from .._lib import NVCC_ARCH_FLAGS

#: the frontier kernels' sources
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: their nvcc flags: subnormals flushed, as the reference flushes them
NVCC_FLAGS = (*NVCC_ARCH_FLAGS, "-ftz=true")

__all__ = [
    "CSRC",
    "CoActivationPacket",
    "FleetPacket",
    "FleetRegimePacket",
    "FleetWhatIfPacket",
    "FrontierPacket",
    "NVCC_FLAGS",
    "RegimePacket",
    "TickInputs",
    "WhatIfPacket",
    "fleet_frontier_loop",
    "fleet_frontier_window",
    "fleet_median_baseline",
    "fleet_regime_stats",
    "fleet_whatif_matrix",
    "frontier_packet",
    "frontier_window",
    "frontier_window_reference",
    "ftz",
    "imputed_work",
    "regime_packet",
    "regime_stats_loop",
    "regime_stats_window",
    "segment_arrivals",
    "stage_prefix",
    "step_makespan",
    "step_sum",
    "tick_inputs",
    "whatif_matrix",
    "whatif_matrix_loop",
    "whatif_stats",
]

#: the regime routes' threshold defaults: the one definition in
#: `core.regimes`
_REGIME_DEFAULTS = _RegimeParams()

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


class FrontierPacket(NamedTuple):
    """Evidence packet of one window d[N, R, S] (the J = 1 squeeze)."""

    frontier: torch.Tensor   # [N, S]
    advances: torch.Tensor   # [N, S]
    leader: torch.Tensor     # [N, S] i32
    gap: torch.Tensor        # [N, S]  max - second (+inf when R == 1)
    exposed: torch.Tensor    # [N]
    shares: torch.Tensor     # [S]     Eq. 2
    gains: torch.Tensor      # [S]     Eq. 4 (clipped static gain)


class WhatIfPacket(NamedTuple):
    """Counterfactual what-if output of one window d[N, R, S]."""

    matrix: torch.Tensor     # [S, R] recoverable seconds per candidate
    exposed: torch.Tensor    # [N]    per-step makespan


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


class RegimePacket(NamedTuple):
    """Regime statistics of one window d[N, R, S], [S, R] each (the J = 1
    squeeze of `FleetRegimePacket`)."""

    count: torch.Tensor
    onset: torch.Tensor
    last: torch.Tensor
    runs: torch.Tensor
    streak: torch.Tensor
    sum_excess: torch.Tensor
    sum_prefix: torch.Tensor
    duty: torch.Tensor
    slope: torch.Tensor


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


def segment_arrivals(pw: torch.Tensor, sync_stages) -> torch.Tensor:
    """[..., S] segment prefix of each stage's governing boundary:
    P[end] - P[start - 1] (P[end] for the first segment), from the stage
    prefix `pw` of the imputed work."""
    cols = []
    for start, end in sync_segments(sync_stages, pw.shape[-1]):
        seg = ftz(pw[..., end] - pw[..., start - 1]) if start else pw[..., end]
        cols.extend([seg] * (end - start + 1))
    return torch.stack(cols, dim=-1)


def step_makespan(d: torch.Tensor) -> torch.Tensor:
    """[J, N] per-step makespan: max over ranks of the last stage prefix,
    which is the frontier family's last stage bit for bit (the what-if
    packets' `exposed`)."""
    return stage_prefix(d)[..., -1].amax(dim=2)


# ---------------------------------------------------------------------------
# the prolog every kernel route shares
# ---------------------------------------------------------------------------


class TickInputs(NamedTuple):
    """The kernels' inputs, as the prolog builds them."""

    d: torch.Tensor              # [J, N, R, S] f32 contiguous
    wmin: torch.Tensor | None    # [J, N, S] cross-rank min (sync stages)
    bd: torch.Tensor             # frontier baseline, view of [J, N, R, S]
    bw: torch.Tensor             # what-if/regime baseline, view
    amax: torch.Tensor           # [J, N, S] what-if boundary stats
    second: torch.Tensor
    leader: torch.Tensor         # i32
    relprev: torch.Tensor
    thr: torch.Tensor | None     # [J, R, S] activity threshold
    host: torch.Tensor | None    # [J, R] i32 rank -> host
    sync: torch.Tensor           # [S] u8, 1 on barrier-bearing stages
    sync_stages: tuple[int, ...]
    num_hosts: int
    with_regimes: bool


def tick_inputs(
    d,
    baseline=None,
    *,
    sync_stages: tuple[int, ...] | None = None,
    host_index=None,
    num_hosts: int = 0,
    with_regimes: bool = True,
    min_excess_s: float = _REGIME_DEFAULTS.min_excess_s,
    rel_excess: float = _REGIME_DEFAULTS.rel_excess,
    device=None,
) -> TickInputs:
    """Validate the arguments of a tick route and run its prolog: the
    sync-imputed work's [J, N, S] cross-rank minimum, the per-job median
    baselines (zero-stride views of [J, S] rows), the what-if boundary
    stats rows and, with regimes or hosts, the activity threshold.

    `device` None keeps a tensor where it lies and puts anything else
    (a NumPy array) on CUDA; pass ``device="cpu"`` for the CPU.
    """
    if device is None:
        device = d.device if isinstance(d, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the tick kernels: CUDA was asked for but is not available "
            "(pass device='cpu' to run their plain versions on the CPU)"
        )
    if isinstance(d, np.ndarray):
        d = torch.from_numpy(np.ascontiguousarray(d))
    # subnormal inputs read as zero, as on a flush-to-zero unit
    d = ftz(torch.as_tensor(d).to(device=device, dtype=torch.float32)).contiguous()
    if d.dim() != 4:
        raise ValueError(f"d must be [J, N, R, S], got {tuple(d.shape)}")
    jn, n, r, s = d.shape
    sync_stages = tuple(sorted({int(i) for i in (sync_stages or ())}))
    sync_segments(sync_stages, s)  # validates the stage indices
    host = None
    if host_index is not None:
        if num_hosts <= 0:
            raise ValueError("host_index requires num_hosts >= 1")
        host = torch.as_tensor(host_index, dtype=torch.int32, device=device)
        if tuple(host.shape) != (jn, r):
            raise ValueError(
                f"host_index must be [J, R]={jn, r}, got {tuple(host.shape)}"
            )
        host = host.contiguous()

    # The frontier family clips against the cohort median of the RAW
    # durations, the what-if and regime families against the median of
    # the sync-imputed work; an explicit baseline serves both, and must
    # be constant over the steps when the regime or host family is on
    # (their threshold is per cell).
    need_jrs = with_regimes or host is not None
    wmin = d.amin(dim=2) if sync_stages else None          # [J, N, S]
    w = imputed_work(d, sync_stages, wmin)
    if baseline is None:
        med_d = fleet_median_baseline(d)                   # [J, S]
        med_w = fleet_median_baseline(w) if sync_stages else med_d
        bd = med_d[:, None, None, :].expand(d.shape)
        bw = med_w[:, None, None, :].expand(d.shape)
    else:
        b = ftz(torch.as_tensor(baseline, dtype=torch.float32, device=device))
        if need_jrs and b.dim() >= 3 and b.shape[-3] != 1:
            raise ValueError(
                "with regimes or hosts the baseline is a per-cell reference: "
                f"it must be constant over the steps, got {tuple(b.shape)}"
            )
        bd = bw = b.broadcast_to(d.shape)
    amax, second, leader, relprev = whatif_stats(w, sync_stages)
    # the sync set as one byte per stage, for the kernels that walk stages
    sync = torch.zeros(s, dtype=torch.uint8)
    sync[list(sync_stages)] = 1
    thr = None
    if need_jrs:
        thr = ftz(torch.clamp_min(
            ftz(float(rel_excess) * bw[:, 0]), float(min_excess_s)
        )).contiguous()
    return TickInputs(
        d, wmin, bd, bw, amax, second, leader, relprev, thr, host,
        sync.to(device), sync_stages, int(num_hosts) if host is not None else 0,
        bool(with_regimes),
    )


# ---------------------------------------------------------------------------
# the epilogs every route shares
# ---------------------------------------------------------------------------


def step_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of [J, N, ...] over the steps (dim 1) by pairwise halving,
    each add flushed: elementwise adds only, in an order fixed by N.

    A reduction kernel picks its add order from the whole tensor's shape:
    on the card `sum(dim=1)` gave a job other last bits when fewer jobs
    were stacked beside it, so a job's shares depended on the jobs that
    shared its launch (a shard's group against the whole fleet's).  Here
    a job's sum never depends on J, and it is the same on every device.
    """
    n = x.shape[1]
    width = 1 << (n - 1).bit_length()
    if width > n:
        pad = x.new_zeros((x.shape[0], width - n) + tuple(x.shape[2:]))
        x = torch.cat([x, pad], dim=1)
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = ftz(x[:, :half] + x[:, half:])
    return x[:, 0]


def frontier_packet(f, lead, sec, clip) -> FleetPacket:
    """[J, N, S] frontier accumulators -> `FleetPacket`."""
    advances = ftz(torch.diff(f, dim=2, prepend=torch.zeros_like(f[:, :, :1])))
    gap = ftz(f - sec)                           # sec = -inf when R == 1
    exposed = f[:, :, -1]                        # [J, N]
    s = f.shape[2]
    # the three sums over the steps in one pass: exposed, advances and
    # exposed - clip, [J, 1 + 2S]
    sums = step_sum(torch.cat(
        [exposed[:, :, None], advances, ftz(exposed[:, :, None] - clip)],
        dim=2,
    ))
    denom = torch.clamp_min(sums[:, 0], 1e-30)
    shares = ftz(sums[:, 1:s + 1] / denom[:, None])
    gains = ftz(torch.clamp_min(sums[:, s + 1:], 0.0) / denom[:, None])
    return FleetPacket(f, advances, lead, gap, exposed, shares, gains)


def regime_packet(count, onset, last, runs, streak, sum_e, sum_pfx, *, n):
    """[J, S, R] regime accumulators of an n-step window ->
    `FleetRegimePacket`: onset BIG -> -1, and the derived duty and
    trend slope."""
    onset = torch.where(onset >= n, -1, onset).to(torch.int32)  # BIG -> never
    span = torch.clamp_min(n - onset, 1).to(torch.float32)
    duty = torch.where(onset >= 0, count.to(torch.float32) / span, 0.0)
    if n >= 2:
        # sum_t t*e = n*sum_e - C, so the least-squares numerator
        # (sum_t (t - tbar) e) is (n - tbar)*sum_e - C
        tbar = (n - 1) / 2.0
        denom = n * (n * n - 1) / 12.0
        slope = ftz(ftz(ftz((n - tbar) * sum_e) - sum_pfx) / denom)
    else:
        slope = torch.zeros_like(sum_e)
    return FleetRegimePacket(
        count, onset, last, runs, streak, sum_e, sum_pfx, duty, slope
    )


# ---------------------------------------------------------------------------
# the single-family kernel routes (the four-dispatch reference path)
# ---------------------------------------------------------------------------

# The kernel wrappers (`frontier.py`) and the oracles (`ref.py`) build on
# the helpers above, so each route imports them when it runs.


def _one(x):
    """The J = 1 stack of one window (or of its baseline)."""
    return None if x is None else x[None]


def fleet_frontier_window(d, baseline=None, *, device=None) -> FleetPacket:
    """Frontier accounting of a stacked-jobs tensor d[J, N, R, S] in one
    launch of the frontier kernel (`frontier.frontier_window_kernel`).

    The baseline defaults to each job's own cohort median of d; jobs never
    share a baseline.  `device` None keeps a tensor's device and puts an
    array on CUDA.  On CUDA the hand-written kernel runs (or the call
    raises); on the CPU its plain torch version does.
    """
    from .frontier import frontier_window_kernel

    x = tick_inputs(d, baseline, with_regimes=False, device=device)
    return frontier_packet(*frontier_window_kernel(x))


def frontier_window(d, baseline=None, *, device=None) -> FrontierPacket:
    """Frontier accounting of one window d[N, R, S]: the J = 1 squeeze of
    `fleet_frontier_window`."""
    p = fleet_frontier_window(_one(d), _one(baseline), device=device)
    return FrontierPacket(*(f[0] for f in p))


def fleet_frontier_loop(d, baseline=None, *, device=None) -> FleetPacket:
    """Per-job loop over `frontier_window` (J launches): the baseline the
    batched route is held against."""
    packets = [
        frontier_window(d[j], None if baseline is None else baseline[j],
                        device=device)
        for j in range(d.shape[0])
    ]
    return FleetPacket(*(torch.stack(col) for col in zip(*packets)))


def frontier_window_reference(d, baseline=None, *, device=None) -> FrontierPacket:
    """The same packet as `frontier_window` from the plain-torch oracle
    `ref.frontier_window_ref` (for tests)."""
    from .ref import frontier_window_ref

    x = tick_inputs(_one(d), _one(baseline), with_regimes=False, device=device)
    ref = frontier_window_ref(x.d[0], x.bd[0])
    p = frontier_packet(
        ref.frontier[None], ref.leader[None], ref.second[None], ref.clipped[None]
    )
    return FrontierPacket(*(f[0] for f in p))


def fleet_whatif_matrix(
    d, baseline=None, *, sync_stages: tuple[int, ...] | None = None, device=None
) -> FleetWhatIfPacket:
    """Per-job what-if matrices of a stacked tensor d[J, N, R, S] in one
    launch of the what-if kernel (`frontier.whatif_matrix_kernel`).

    Every (stage, rank) candidate is clipped to the baseline (default:
    each job's cohort median of the sync-imputed work) and the step
    makespan replayed under the declared sync model.  `sync_stages` must
    be identical across the stacked jobs.  `exposed` is the per-step
    makespan as the fused route computes it (`step_makespan`).
    """
    from .frontier import whatif_matrix_kernel

    x = tick_inputs(
        d, baseline, sync_stages=sync_stages, with_regimes=False, device=device
    )
    return FleetWhatIfPacket(whatif_matrix_kernel(x), step_makespan(x.d))


def whatif_matrix(
    d, baseline=None, *, sync_stages: tuple[int, ...] | None = None, device=None
) -> WhatIfPacket:
    """The [S, R] what-if matrix of one window d[N, R, S]: the J = 1
    squeeze of `fleet_whatif_matrix`."""
    p = fleet_whatif_matrix(
        _one(d), _one(baseline), sync_stages=sync_stages, device=device
    )
    return WhatIfPacket(matrix=p.matrix[0], exposed=p.exposed[0])


def _replay_exposed(w: torch.Tensor, segments) -> torch.Tensor:
    """Per-step replayed makespan [N] of work w[N, R, S]."""
    p = stage_prefix(w)
    relbase = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)
    for start, end in segments:
        seg = ftz(p[:, :, end] - p[:, :, start - 1]) if start else p[:, :, end]
        relbase = ftz(relbase[:, None] + seg).amax(dim=1)
    return relbase


def whatif_matrix_loop(
    d, baseline=None, *, sync_stages: tuple[int, ...] | None = None, device=None
) -> torch.Tensor:
    """Per-candidate counterfactual loop: one full sync replay per (stage,
    rank), O(S*R) passes over the window.  The route the batched kernel is
    held against; for tests only, never to serve.  Returns [S, R]."""
    x = tick_inputs(
        _one(d), _one(baseline), sync_stages=sync_stages, with_regimes=False,
        device=device,
    )
    w = imputed_work(x.d, x.sync_stages, x.wmin)[0]
    b = x.bw[0]
    n, r, s = w.shape
    segments = sync_segments(x.sync_stages, s)
    base = _replay_exposed(w, segments).sum()
    out = torch.empty((s, r), dtype=torch.float32, device=w.device)
    for si in range(s):
        for ri in range(r):
            repl = w.clone()
            repl[:, ri, si] = torch.minimum(w[:, ri, si], b[:, ri, si])
            out[si, ri] = base - _replay_exposed(repl, segments).sum()
    return out


def fleet_regime_stats(
    d,
    baseline=None,
    *,
    sync_stages: tuple[int, ...] | None = None,
    min_excess_s: float = _REGIME_DEFAULTS.min_excess_s,
    rel_excess: float = _REGIME_DEFAULTS.rel_excess,
    device=None,
) -> FleetRegimePacket:
    """Per-job regime statistics of a stacked tensor d[J, N, R, S] in one
    launch of the regime kernel (`frontier.regime_stats_kernel`).

    `baseline` is the per-cell reference ([J, R, S], or broadcastable); it
    defaults to each job's cohort median of the sync-imputed work.  The
    activity threshold is max(min_excess_s, rel_excess * baseline).
    """
    from .frontier import regime_stats_kernel

    if baseline is not None:
        jn, _, r, s = np.shape(d)
        baseline = torch.as_tensor(baseline, dtype=torch.float32).broadcast_to(
            (jn, r, s)
        )[:, None]                                  # constant over steps
    x = tick_inputs(
        d, baseline, sync_stages=sync_stages, with_regimes=True,
        min_excess_s=min_excess_s, rel_excess=rel_excess, device=device,
    )
    return regime_packet(*regime_stats_kernel(x), n=x.d.shape[1])


def regime_stats_window(
    d,
    baseline=None,
    *,
    sync_stages: tuple[int, ...] | None = None,
    min_excess_s: float = _REGIME_DEFAULTS.min_excess_s,
    rel_excess: float = _REGIME_DEFAULTS.rel_excess,
    device=None,
) -> RegimePacket:
    """Regime statistics of one window d[N, R, S]: the J = 1 squeeze of
    `fleet_regime_stats`."""
    p = fleet_regime_stats(
        _one(d), _one(baseline), sync_stages=sync_stages,
        min_excess_s=min_excess_s, rel_excess=rel_excess, device=device,
    )
    return RegimePacket(*(f[0] for f in p))


def regime_stats_loop(
    d,
    baseline=None,
    *,
    sync_stages: tuple[int, ...] | None = None,
    min_excess_s: float = _REGIME_DEFAULTS.min_excess_s,
    rel_excess: float = _REGIME_DEFAULTS.rel_excess,
    device=None,
) -> FleetRegimePacket:
    """Per-job loop over `regime_stats_window` (J launches): the baseline
    the batched route is held against."""
    packets = [
        regime_stats_window(
            d[j], None if baseline is None else baseline[j],
            sync_stages=sync_stages, min_excess_s=min_excess_s,
            rel_excess=rel_excess, device=device,
        )
        for j in range(d.shape[0])
    ]
    return FleetRegimePacket(*(torch.stack(col) for col in zip(*packets)))
