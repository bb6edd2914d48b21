"""The fused fleet tick: one CUDA kernel over the stacked windows.

Every tick the fleet service needs the analyses of one stacked window
tensor d[J, N, R, S]: frontier accounting, the counterfactual what-if
matrix, temporal regime statistics and host co-activation counts.
`fused_fleet_tick` runs them as

  prolog  (torch)  sync-imputed work as a [J, N, S] cross-rank minimum,
                   the per-job cohort median baselines ([J, S], passed to
                   the kernel as zero-stride views, never materialized at
                   window size), the what-if boundary stats rows;
  kernel  (CUDA)   `csrc/fused_tick.cu`: all four accumulator families
                   from one read of the window (see the source note for
                   the design and its bound);
  epilog  (torch)  shares, gains, gaps, regime duty/slope and the
                   cross-job co-activation reduction.

`_fused_tick_plain` is the same accumulator function in plain torch,
with Python loops over the steps for the folds.  The wrapper uses it only
for tensors on the CPU (the tests); for a CUDA tensor it launches the
kernel or raises.

Tolerance against the reference package: the folds add in the same step
order, but the epilog's vectorised sums (shares, gains, exposed) take
another order than XLA's, so float fields agree within rtol 1e-5 /
atol 1e-6 and integer fields exactly.  The what-if `exposed` row is the
frontier's last stage (the per-step makespan max_r sum_s d, summed in
stage order) instead of a second pass over the window.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ...core.regimes import RegimeParams as _RegimeParams
from ...core.whatif import sync_segments
from . import _lib
from .ops import (
    BIG_IDX,
    CoActivationPacket,
    FleetPacket,
    FleetRegimePacket,
    FleetWhatIfPacket,
    fleet_median_baseline,
    ftz,
    imputed_work,
    stage_prefix,
    whatif_stats,
)

__all__ = ["FusedTickPacket", "TickInputs", "fused_fleet_tick", "tick_inputs"]

_REGIME_DEFAULTS = _RegimeParams()
_SOURCE = "fused_tick.cu"
_THREADS = 128  # ranks per block: one rank tile

#: launches of the fused tick kernel: `_fused_tick_cuda` adds one per
#: launch and nothing else touches it (callers reset it to 0 to count a
#: run)
launches = 0


class FusedTickPacket(NamedTuple):
    """All per-tick evidence families from one window read.

    `regimes` / `coact` are None when the family was not requested
    (`with_regimes=False`, `host_index=None`) — the service hot path
    only consumes the first two.
    """

    frontier: FleetPacket
    whatif: FleetWhatIfPacket
    regimes: FleetRegimePacket | None
    coact: CoActivationPacket | None


class TickInputs(NamedTuple):
    """The kernel's inputs, as the prolog builds them."""

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


class TickAccumulators(NamedTuple):
    """The kernel's outputs (what the epilog turns into packets)."""

    frontier: torch.Tensor       # [J, N, S]
    leader: torch.Tensor         # [J, N, S] i32
    second: torch.Tensor         # [J, N, S]
    clipped: torch.Tensor        # [J, N, S]
    whatif: torch.Tensor         # [J, S, R]
    regimes: tuple[torch.Tensor, ...] | None  # 5 x i32 + 2 x f32 [J, S, R]
    hostcnt: torch.Tensor | None  # [J, N, S, H] i32


# ---------------------------------------------------------------------------
# the kernel wrapper and its plain version
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of `csrc/fused_tick.cu`."""
    lib.fused_tick_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_void_p,
    ]
    lib.fused_tick_launch.restype = ctypes.c_int
    lib.fused_tick_num_slots.argtypes = [ctypes.c_int]
    lib.fused_tick_num_slots.restype = ctypes.c_int
    lib.fused_tick_error_string.argtypes = [ctypes.c_int]
    lib.fused_tick_error_string.restype = ctypes.c_char_p


def _check(t: torch.Tensor, name: str, shape, dtype, device, *,
           contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _fused_tick_cuda(x: TickInputs) -> TickAccumulators:
    """Launch `csrc/fused_tick.cu` on tensors on one CUDA device."""
    global launches
    d = x.d
    dev = d.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA tick kernel needs CUDA tensors, got {dev}")
    if d.dim() != 4 or min(d.shape) < 1:
        raise ValueError(f"d must be a non-empty [J, N, R, S], got {tuple(d.shape)}")
    jn, n, r, s = d.shape
    lib = _lib.load_library(_SOURCE, _bind)
    f32, i32 = torch.float32, torch.int32
    _check(d, "d", (jn, n, r, s), f32, dev)
    for name in ("bd", "bw"):
        _check(getattr(x, name), name, (jn, n, r, s), f32, dev, contiguous=False)
    for name in ("amax", "second", "relprev"):
        _check(getattr(x, name), name, (jn, n, s), f32, dev)
    _check(x.leader, "leader", (jn, n, s), i32, dev)
    _check(x.sync, "sync", (s,), torch.uint8, dev)
    if x.sync_stages:
        _check(x.wmin, "wmin", (jn, n, s), f32, dev)
    with_hosts = x.host is not None
    if x.with_regimes or with_hosts:
        _check(x.thr, "thr", (jn, r, s), f32, dev)
    if with_hosts:
        _check(x.host, "host", (jn, r), i32, dev)
        if x.num_hosts < 1:
            raise ValueError("the host family needs num_hosts >= 1")

    tiles = -(-r // _THREADS)

    def empty(shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    f, fl, fs, fc = (empty((jn, n, s), t) for t in (f32, i32, f32, f32))
    if tiles > 1:
        parts = [empty((jn, tiles, n, s), t) for t in (f32, i32, f32, f32)]
    else:
        parts = [f, fl, fs, fc]
    wif = empty((jn, s, r))
    regimes = None
    if x.with_regimes:
        regimes = tuple(empty((jn, s, r), i32) for _ in range(5)) + tuple(
            empty((jn, s, r)) for _ in range(2)
        )
    hostcnt = None
    if with_hosts:
        hostcnt = torch.zeros((jn, n, s, x.num_hosts), dtype=i32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    reg = regimes if regimes is not None else (None,) * 7
    # the register variants (S <= 16) take the sync set as bits, the wide
    # variant as the prolog's byte per stage
    sync_mask = sum(1 << i for i in x.sync_stages) if s <= 16 else 0
    ptrs = [
        ptr(d), ptr(x.wmin if x.sync_stages else d), ptr(x.bd), ptr(x.bw),
        ptr(x.amax), ptr(x.second), ptr(x.leader), ptr(x.relprev),
        ptr(x.thr), ptr(x.host), ptr(x.sync),
        *(ptr(t) for t in parts), ptr(f), ptr(fl), ptr(fs), ptr(fc),
        ptr(wif), *(ptr(t) for t in reg), ptr(hostcnt),
    ]
    ints = [
        jn, n, r, s, x.num_hosts, tiles, sync_mask,
        int(x.with_regimes), int(with_hosts),
        *x.bd.stride(), *x.bw.stride(),
    ]
    if len(ptrs) != lib.fused_tick_num_slots(0) or len(ints) != lib.fused_tick_num_slots(1):
        raise RuntimeError("fused tick argument slots disagree with the library")
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    int_arr = (ctypes.c_longlong * len(ints))(*ints)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_tick_launch(ptr_arr, int_arr, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.fused_tick_error_string(rc).decode()
        raise RuntimeError(f"fused tick kernel launch failed: {msg} ({rc})")
    launches += 1
    return TickAccumulators(f, fl, fs, fc, wif, regimes, hostcnt)


def _segment_arrivals(pw: torch.Tensor, sync_stages) -> torch.Tensor:
    """[..., S] segment prefix of each stage's governing boundary:
    P[end] - P[start - 1] (P[end] for the first segment)."""
    cols = []
    for start, end in sync_segments(sync_stages, pw.shape[-1]):
        seg = ftz(pw[..., end] - pw[..., start - 1]) if start else pw[..., end]
        cols.extend([seg] * (end - start + 1))
    return torch.stack(cols, dim=-1)


def _fused_tick_plain(x: TickInputs) -> TickAccumulators:
    """The kernel's function in plain torch, steps folded in Python."""
    d = x.d
    jn, n, r, s = d.shape
    dev = d.device
    ranks = torch.arange(r, dtype=torch.int32, device=dev).view(1, 1, r, 1)
    neg_inf = float("-inf")

    # frontier family
    pd = stage_prefix(d)
    f = pd.amax(dim=2)
    fl = torch.where(pd == f[:, :, None], ranks, BIG_IDX).amin(dim=2)
    fs = torch.where(ranks == fl[:, :, None], neg_inf, pd).amax(dim=2)
    fc = ftz(pd[..., -1:] - torch.clamp_min(ftz(d - x.bd), 0.0)).amax(dim=2)

    # what-if family
    w = imputed_work(d, x.sync_stages, x.wmin)
    ew = torch.clamp_min(ftz(w - x.bw), 0.0)
    arr = ftz(
        x.relprev[:, :, None] + _segment_arrivals(stage_prefix(w), x.sync_stages)
    )
    amax = x.amax[:, :, None]
    other = torch.where(ranks == x.leader[:, :, None], x.second[:, :, None], amax)
    contrib = torch.clamp_min(
        ftz(amax - torch.maximum(other, ftz(arr - ew))), 0.0
    )
    wacc = torch.zeros((jn, r, s), dtype=torch.float32, device=dev)
    for t in range(n):
        wacc = ftz(wacc + contrib[:, t])
    wif = wacc.permute(0, 2, 1).contiguous()

    act = ew > x.thr[:, None] if x.thr is not None else None
    regimes = None
    if x.with_regimes:
        zi = torch.zeros((jn, r, s), dtype=torch.int32, device=dev)
        count, runs, streak, prev = zi, zi, zi, zi
        onset, last = zi + BIG_IDX, zi - 1
        sume = torch.zeros((jn, r, s), dtype=torch.float32, device=dev)
        sumpfx = sume
        for t in range(n):
            a = act[:, t]
            ai = a.to(torch.int32)
            count = count + ai
            onset = torch.minimum(onset, torch.where(a, t, BIG_IDX).to(torch.int32))
            last = torch.maximum(last, torch.where(a, t, -1).to(torch.int32))
            runs = runs + ai * (1 - prev)
            streak = torch.where(a, streak + 1, 0).to(torch.int32)
            prev = ai
            sume = ftz(sume + ew[:, t])
            sumpfx = ftz(sumpfx + sume)
        regimes = tuple(
            v.permute(0, 2, 1).contiguous()
            for v in (count, onset, last, runs, streak, sume, sumpfx)
        )

    hostcnt = None
    if x.host is not None:
        h = x.num_hosts
        # out-of-range hosts land in a spill column that is dropped
        idx = torch.where((x.host >= 0) & (x.host < h), x.host, h).long()
        cnt = torch.zeros((jn, n, s, h + 1), dtype=torch.int32, device=dev)
        cnt.scatter_add_(
            3,
            idx[:, None, None, :].expand(jn, n, s, r),
            act.permute(0, 1, 3, 2).to(torch.int32),
        )
        hostcnt = cnt[..., :h].contiguous()
    return TickAccumulators(f, fl.to(torch.int32), fs, fc, wif, regimes, hostcnt)


def _accumulate(x: TickInputs) -> TickAccumulators:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if x.d.device.type == "cuda":
        return _fused_tick_cuda(x)
    if x.d.device.type == "cpu":
        return _fused_tick_plain(x)
    raise ValueError(f"unsupported device {x.d.device}")


# ---------------------------------------------------------------------------
# epilog
# ---------------------------------------------------------------------------


def _frontier_packet(f, lead, sec, clip) -> FleetPacket:
    advances = ftz(torch.diff(f, dim=2, prepend=torch.zeros_like(f[:, :, :1])))
    gap = ftz(f - sec)                           # sec = -inf when R == 1
    exposed = f[:, :, -1]                        # [J, N]
    denom = torch.clamp_min(ftz(exposed.sum(dim=1)), 1e-30)
    shares = ftz(ftz(advances.sum(dim=1)) / denom[:, None])
    gains = ftz(
        torch.clamp_min(ftz(ftz(exposed[:, :, None] - clip).sum(dim=1)), 0.0)
        / denom[:, None]
    )
    return FleetPacket(f, advances, lead, gap, exposed, shares, gains)


def _regime_packet(count, onset, last, runs, streak, sum_e, sum_pfx, *, n):
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


def _coact_packet(hostcnt: torch.Tensor) -> CoActivationPacket:
    """[J, N, S, H] active-rank counts -> cross-job statistics [S, H]."""
    ah = (hostcnt > 0).to(torch.int32)
    stepsum = ah.sum(dim=0, dtype=torch.int32)               # [N, S, H]
    return CoActivationPacket(
        jobs=ah.amax(dim=1).sum(dim=0, dtype=torch.int32),
        coact=(stepsum >= 2).sum(dim=0, dtype=torch.int32),
        active=stepsum.sum(dim=0, dtype=torch.int32),
    )


def _epilog(x: TickInputs, acc: TickAccumulators) -> FusedTickPacket:
    front = _frontier_packet(acc.frontier, acc.leader, acc.second, acc.clipped)
    whatif = FleetWhatIfPacket(matrix=acc.whatif, exposed=front.exposed)
    regimes = None
    if acc.regimes is not None:
        regimes = _regime_packet(*acc.regimes, n=x.d.shape[1])
    coact = None if acc.hostcnt is None else _coact_packet(acc.hostcnt)
    return FusedTickPacket(front, whatif, regimes, coact)


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


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
    """Validate the arguments of `fused_fleet_tick` and run its prolog:
    the sync-imputed work's [J, N, S] cross-rank minimum, the per-job
    median baselines (zero-stride views of [J, S] rows) and the what-if
    boundary stats rows.

    `device` None keeps a tensor where it lies and puts anything else
    (a NumPy array) on CUDA; pass ``device="cpu"`` for the CPU.
    """
    if device is None:
        device = d.device if isinstance(d, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fused_fleet_tick: CUDA was asked for but is not available "
            "(pass device='cpu' to run the plain version on the CPU)"
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
    # broadcast to [J, R, S] when the regime or host family is on (their
    # threshold is per cell).
    need_jrs = with_regimes or host is not None
    wmin = d.amin(dim=2) if sync_stages else None          # [J, N, S]
    w = imputed_work(d, sync_stages, wmin)
    if baseline is None:
        med_d = fleet_median_baseline(d)                   # [J, S]
        med_w = fleet_median_baseline(w) if sync_stages else med_d
        bd = med_d[:, None, None, :].expand(d.shape)
        bw = med_w[:, None, None, :].expand(d.shape)
        bw_jrs = med_w[:, None, :].expand(jn, r, s)
    else:
        b = ftz(torch.as_tensor(baseline, dtype=torch.float32, device=device))
        bd = bw = b.broadcast_to(d.shape)
        bw_jrs = b.broadcast_to((jn, r, s)) if need_jrs else None
    amax, second, leader, relprev = whatif_stats(w, sync_stages)
    # the sync set as one byte per stage, for the kernel's wide variant
    sync = torch.zeros(s, dtype=torch.uint8)
    sync[list(sync_stages)] = 1
    thr = None
    if need_jrs:
        thr = ftz(torch.clamp_min(
            ftz(float(rel_excess) * bw_jrs), float(min_excess_s)
        )).contiguous()
    return TickInputs(
        d, wmin, bd, bw, amax, second, leader, relprev, thr, host,
        sync.to(device), sync_stages, int(num_hosts) if host is not None else 0,
        bool(with_regimes),
    )


def fused_fleet_tick(
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
) -> FusedTickPacket:
    """All per-tick analyses of d[J, N, R, S] from one kernel launch.

    Args:
      d: stacked fleet window tensor [J, N, R, S] (tensor or array).
      baseline: explicit clip reference (broadcastable to d; must be
        broadcastable to [J, R, S] when regimes/co-activation are on).
        None = each job's own cohort medians (raw d for the frontier
        family, sync-imputed work for the rest).
      sync_stages: barrier-bearing stage indices (identical across the
        stacked jobs).
      host_index: [J, R] rank->host map (with `num_hosts`); enables the
        co-activation family.  None = family off.
      with_regimes: compute the regime-statistics family.
      device: where to run; None keeps a tensor's device and puts an
        array on CUDA.  On CUDA the hand-written kernel runs (or the
        call raises); on the CPU its plain torch version does.

    Returns a `FusedTickPacket` of tensors on that device.  The reference
    package's `donate` flag has no counterpart: the staged window is an
    ordinary tensor the caller may drop after the call.
    """
    x = tick_inputs(
        d, baseline,
        sync_stages=sync_stages, host_index=host_index, num_hosts=num_hosts,
        with_regimes=with_regimes, min_excess_s=min_excess_s,
        rel_excess=rel_excess, device=device,
    )
    return _epilog(x, _accumulate(x))
