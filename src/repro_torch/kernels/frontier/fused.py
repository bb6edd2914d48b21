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
                   in one call, as a frontier role spread over (job,
                   step chunk, rank tile) and a cell role that walks the
                   steps once per (job, rank, stage) cell (see the source
                   note for the design and its bound);
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

`four_dispatch_tick` keeps the unfused composition as the reference
route (`FleetService(fused=False)`): the same prolog, then the three
single-family kernels of `frontier.py` and the co-activation kernel,
each a separate launch that re-reads the window, and the same epilogs.
Its contract is bit-identity with `fused_fleet_tick` on every field of
every family, on the card and on the CPU, so a divergence between the
two routes is a kernel fault.  `fused_tick_ref` composes the per-window
oracles of `ref.py` into the same packet.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...core.regimes import RegimeParams as _RegimeParams
from .. import _lib
from .frontier import (
    _excess,
    _frontier_plain,
    _regime_plain,
    _whatif_plain,
    frontier_window_kernel,
    regime_stats_kernel,
    whatif_matrix_kernel,
)
from .incidents import co_activation, co_activation_ref
from .ops import (
    CSRC,
    NVCC_FLAGS,
    CoActivationPacket,
    FleetPacket,
    FleetRegimePacket,
    FleetWhatIfPacket,
    TickInputs,
    frontier_packet,
    regime_packet,
    tick_inputs,
)
from .ref import frontier_window_ref, regime_segments_ref, whatif_matrix_ref

__all__ = [
    "FusedTickPacket",
    "TickInputs",
    "four_dispatch_tick",
    "fused_fleet_tick",
    "fused_tick_ref",
    "tick_inputs",
]

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
    lib.fused_tick_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.fused_tick_scratch_floats.restype = ctypes.c_longlong
    lib.fused_tick_error_string.argtypes = [ctypes.c_int]
    lib.fused_tick_error_string.restype = ctypes.c_char_p


def _fused_tick_cuda(x: TickInputs) -> TickAccumulators:
    """Launch `csrc/fused_tick.cu` on tensors on one CUDA device."""
    d = x.d
    dev = d.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA tick kernel needs CUDA tensors, got {dev}")
    if d.dim() != 4 or min(d.shape) < 1:
        raise ValueError(f"d must be a non-empty [J, N, R, S], got {tuple(d.shape)}")
    jn, n, r, s = d.shape
    lib = _lib.load_library(_SOURCE, _bind, CSRC, NVCC_FLAGS)
    f32, i32 = torch.float32, torch.int32
    _lib.check_tensor(d, "d", (jn, n, r, s), f32, dev)
    for name in ("bd", "bw"):
        _lib.check_tensor(getattr(x, name), name, (jn, n, r, s), f32, dev,
                          contiguous=False)
    for name in ("amax", "second", "relprev"):
        _lib.check_tensor(getattr(x, name), name, (jn, n, s), f32, dev)
    _lib.check_tensor(x.leader, "leader", (jn, n, s), i32, dev)
    _lib.check_tensor(x.sync, "sync", (s,), torch.uint8, dev)
    if x.sync_stages:
        _lib.check_tensor(x.wmin, "wmin", (jn, n, s), f32, dev)
    with_hosts = x.host is not None
    if x.with_regimes or with_hosts:
        _lib.check_tensor(x.thr, "thr", (jn, r, s), f32, dev)
    if with_hosts:
        _lib.check_tensor(x.host, "host", (jn, r), i32, dev)
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
    # the cell walk's segment sums past 32 stages (the library's count)
    scratch = lib.fused_tick_scratch_floats(jn, n, r, s)
    seg = empty((scratch,)) if scratch else None

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    reg = regimes if regimes is not None else (None,) * 7
    ptrs = [
        ptr(d), ptr(x.wmin if x.sync_stages else d), ptr(x.bd), ptr(x.bw),
        ptr(x.amax), ptr(x.second), ptr(x.leader), ptr(x.relprev),
        ptr(x.thr), ptr(x.host), ptr(x.sync), ptr(seg),
        *(ptr(t) for t in parts), ptr(f), ptr(fl), ptr(fs), ptr(fc),
        ptr(wif), *(ptr(t) for t in reg), ptr(hostcnt),
    ]
    ints = [
        jn, n, r, s, x.num_hosts, tiles, int(x.with_regimes), int(with_hosts),
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
    _lib.count_launch(globals(), "launches")
    return TickAccumulators(f, fl, fs, fc, wif, regimes, hostcnt)


def _host_counts(x: TickInputs) -> torch.Tensor:
    """[J, N, S, H] int32 active-rank counts per host: the activity
    ``e > thr`` collapsed rank -> host (ranks of no host in range are
    dropped)."""
    jn, n, r, s = x.d.shape
    act = _excess(x) > x.thr[:, None]
    h = x.num_hosts
    # out-of-range hosts land in a spill column that is dropped
    idx = torch.where((x.host >= 0) & (x.host < h), x.host, h).long()
    cnt = torch.zeros((jn, n, s, h + 1), dtype=torch.int32, device=x.d.device)
    cnt.scatter_add_(
        3,
        idx[:, None, None, :].expand(jn, n, s, r),
        act.permute(0, 1, 3, 2).to(torch.int32),
    )
    return cnt[..., :h].contiguous()


def _fused_tick_plain(x: TickInputs) -> TickAccumulators:
    """The kernel's function in plain torch: the families' plain versions
    (`frontier.py`) and the host counts, steps folded in Python."""
    f, fl, fs, fc = _frontier_plain(x)
    regimes = _regime_plain(x) if x.with_regimes else None
    hostcnt = _host_counts(x) if x.host is not None else None
    return TickAccumulators(f, fl, fs, fc, _whatif_plain(x), regimes, hostcnt)


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
    front = frontier_packet(acc.frontier, acc.leader, acc.second, acc.clipped)
    whatif = FleetWhatIfPacket(matrix=acc.whatif, exposed=front.exposed)
    regimes = None
    if acc.regimes is not None:
        regimes = regime_packet(*acc.regimes, n=x.d.shape[1])
    coact = None if acc.hostcnt is None else _coact_packet(acc.hostcnt)
    return FusedTickPacket(front, whatif, regimes, coact)


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# the four-dispatch reference route and the composed oracle
# ---------------------------------------------------------------------------


def _host_activity(x: TickInputs) -> torch.Tensor:
    """[J, N, H, S] bool host-level activity: the regime activity mask
    (``e > thr``, the kernels' formulas) collapsed rank -> host."""
    return (_host_counts(x) > 0).permute(0, 1, 3, 2)


def four_dispatch_tick(
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
    """The SAME packet as `fused_fleet_tick` from separate launches.

    The prolog `fused_fleet_tick` runs, then the frontier kernel, the
    what-if kernel, the regime kernel (with `with_regimes`) and the
    co-activation kernel on the host-collapsed activity (with
    `host_index`), each re-reading the window, and the shared epilogs.
    Arguments as `fused_fleet_tick`.  The reference route the fused
    kernel is held against, and the route `FleetService(fused=False)`
    takes: bit-identical to `fused_fleet_tick` on every field.
    """
    x = tick_inputs(
        d, baseline,
        sync_stages=sync_stages, host_index=host_index, num_hosts=num_hosts,
        with_regimes=with_regimes, min_excess_s=min_excess_s,
        rel_excess=rel_excess, device=device,
    )
    front = frontier_packet(*frontier_window_kernel(x))
    whatif = FleetWhatIfPacket(whatif_matrix_kernel(x), front.exposed)
    regimes = None
    if x.with_regimes:
        regimes = regime_packet(*regime_stats_kernel(x), n=x.d.shape[1])
    coact = None
    if x.host is not None:
        coact = co_activation(_host_activity(x))
    return FusedTickPacket(front, whatif, regimes, coact)


def fused_tick_ref(
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
    """Oracle: the tick composed from the per-window references.

    Runs `frontier_window_ref`, `whatif_matrix_ref` and
    `regime_segments_ref` job by job and `co_activation_ref` (NumPy) on
    the host-collapsed activity, stacks them and applies the shared
    epilogs, so both kernel routes must match it bit for bit.  Arguments
    as `fused_fleet_tick`; plain torch on any device.
    """
    x = tick_inputs(
        d, baseline,
        sync_stages=sync_stages, host_index=host_index, num_hosts=num_hosts,
        with_regimes=with_regimes, min_excess_s=min_excess_s,
        rel_excess=rel_excess, device=device,
    )
    jn, n = x.d.shape[:2]

    def stack(packets, fields):
        return [torch.stack([getattr(p, f) for p in packets]) for f in fields]

    fws = [frontier_window_ref(x.d[j], x.bd[j]) for j in range(jn)]
    front = frontier_packet(*stack(fws, ("frontier", "leader", "second", "clipped")))
    whatif = FleetWhatIfPacket(
        matrix=torch.stack([
            whatif_matrix_ref(x.d[j], x.bw[j], x.sync_stages) for j in range(jn)
        ]),
        exposed=front.exposed,
    )
    regimes = None
    if x.with_regimes:
        rws = [
            regime_segments_ref(
                x.d[j], x.bw[j, 0], sync_stages=x.sync_stages,
                min_excess_s=min_excess_s, rel_excess=rel_excess,
            )
            for j in range(jn)
        ]
        regimes = regime_packet(*stack(rws, rws[0]._fields), n=n)
    coact = None
    if x.host is not None:
        ref = co_activation_ref(_host_activity(x).cpu().numpy())
        coact = CoActivationPacket(
            *(torch.from_numpy(a).to(x.d.device) for a in ref)
        )
    return FusedTickPacket(front, whatif, regimes, coact)
