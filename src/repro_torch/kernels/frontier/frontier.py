"""The frontier, what-if and regime kernels: one CUDA launch per family.

The counterpart of the reference package's `kernels/frontier/frontier.py`,
which holds three Pallas kernels.  Each of them became a hand-written
CUDA kernel for Hopper (sm_90a), in a source of its own:

  `frontier_window_kernel`  `csrc/frontier_window.cu`: per (job, step,
                            stage) frontier, leader, second and clipped;
  `whatif_matrix_kernel`    `csrc/whatif_matrix.cu`: per (job, stage,
                            rank) recoverable seconds;
  `regime_stats_kernel`     `csrc/regime_stats.cu`: per (job, stage, rank)
                            the seven temporal statistics.

Each takes the prolog's `ops.TickInputs` and returns the accumulators the
shared epilogs (`ops.frontier_packet`, `ops.regime_packet`) turn into
packets.  On a CUDA tensor it launches its kernel or raises; on a CPU
tensor it runs its plain torch version (`_frontier_plain`,
`_whatif_plain`, `_regime_plain`), which the fused tick's plain version
composes too.  It never falls back from one to the other.

Together they are the four-dispatch reference route
(`fused.four_dispatch_tick`): separate launches, each re-reading the
window, held bit for bit against the fused tick kernel, which computes
all the families in one call.  The what-if and regime kernels are the
fused kernel's cell role (`csrc/cell_walk.cuh`) with the what-if family
alone and with the regime family alone.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _lib
from .ops import (
    BIG_IDX,
    CSRC,
    NVCC_FLAGS,
    TickInputs,
    ftz,
    imputed_work,
    segment_arrivals,
    stage_prefix,
)

__all__ = [
    "frontier_window_kernel",
    "regime_stats_kernel",
    "whatif_matrix_kernel",
]


#: launches of each kernel of this module: its CUDA wrapper adds one per
#: launch and nothing else touches it (callers reset the counts to 0 to
#: count a run)
launches = {"frontier_window": 0, "whatif_matrix": 0, "regime_stats": 0}


def _window(x: TickInputs, kernel: str) -> tuple[int, int, int, int]:
    """Check the window of `x` for a CUDA launch; returns its shape."""
    d = x.d
    if d.device.type != "cuda":
        raise ValueError(f"the CUDA {kernel} kernel needs CUDA tensors, got {d.device}")
    if d.dim() != 4 or min(d.shape) < 1:
        raise ValueError(f"d must be a non-empty [J, N, R, S], got {tuple(d.shape)}")
    _lib.check_tensor(d, "d", d.shape, torch.float32, d.device)
    return tuple(d.shape)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(rc: int, lib, kernel: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{kernel}_error_string")(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")


def _dispatch(x: TickInputs, cuda, plain):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if x.d.device.type == "cuda":
        return cuda(x)
    if x.d.device.type == "cpu":
        return plain(x)
    raise ValueError(f"unsupported device {x.d.device}")


def _excess(x: TickInputs) -> torch.Tensor:
    """[J, N, R, S] exposed increment max(0, w - bw) of the imputed work."""
    w = imputed_work(x.d, x.sync_stages, x.wmin)
    return torch.clamp_min(ftz(w - x.bw), 0.0)


# ---------------------------------------------------------------------------
# kernel 2: the frontier family
# ---------------------------------------------------------------------------


def _bind_frontier(lib: ctypes.CDLL) -> None:
    """Declare the C interface of `csrc/frontier_window.cu`."""
    lib.frontier_window_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.frontier_window_launch.restype = ctypes.c_int
    lib.frontier_window_tiles.argtypes = [ctypes.c_int] * 2
    lib.frontier_window_tiles.restype = ctypes.c_int
    lib.frontier_window_error_string.argtypes = [ctypes.c_int]
    lib.frontier_window_error_string.restype = ctypes.c_char_p


def _frontier_cuda(x: TickInputs):
    """Launch `csrc/frontier_window.cu` on tensors on one CUDA device."""
    jn, n, r, s = _window(x, "frontier_window")
    dev = x.d.device
    _lib.check_tensor(x.bd, "bd", (jn, n, r, s), torch.float32, dev,
                      contiguous=False)
    lib = _lib.load_library("frontier_window.cu", _bind_frontier, CSRC, NVCC_FLAGS)
    # the kernel's own rule: one block over every rank (no partials), or
    # rank tiles and a fold of their partials
    tiles = lib.frontier_window_tiles(r, s)
    types = (torch.float32, torch.int32, torch.float32, torch.float32)
    out = [torch.empty((jn, n, s), dtype=t, device=dev) for t in types]
    parts = out
    if tiles > 1:
        parts = [torch.empty((jn, n, tiles, s), dtype=t, device=dev) for t in types]
    with torch.cuda.device(dev):
        rc = lib.frontier_window_launch(
            x.d.data_ptr(), x.bd.data_ptr(), *(t.data_ptr() for t in parts),
            *(t.data_ptr() for t in out), _strides(x.bd), jn, n, r, s, tiles,
            _stream(dev),
        )
    _raise_on(rc, lib, "frontier_window")
    _lib.count_launch(launches, "frontier_window")
    return tuple(out)


def _frontier_plain(x: TickInputs):
    """The frontier kernel's function in plain torch."""
    d = x.d
    r = d.shape[2]
    ranks = torch.arange(r, dtype=torch.int32, device=d.device).view(1, 1, r, 1)
    pd = stage_prefix(d)
    f = pd.amax(dim=2)
    fl = torch.where(pd == f[:, :, None], ranks, BIG_IDX).amin(dim=2)
    fs = torch.where(ranks == fl[:, :, None], float("-inf"), pd).amax(dim=2)
    fc = ftz(pd[..., -1:] - torch.clamp_min(ftz(d - x.bd), 0.0)).amax(dim=2)
    return f, fl.to(torch.int32), fs, fc


def frontier_window_kernel(x: TickInputs):
    """(frontier, leader, second, clipped), each [J, N, S], of the window
    `x.d` against the clip baseline `x.bd`: one launch on CUDA."""
    return _dispatch(x, _frontier_cuda, _frontier_plain)


# ---------------------------------------------------------------------------
# kernel 3: the what-if family
# ---------------------------------------------------------------------------


def _bind_whatif(lib: ctypes.CDLL) -> None:
    """Declare the C interface of `csrc/whatif_matrix.cu`."""
    lib.whatif_matrix_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.whatif_matrix_launch.restype = ctypes.c_int
    lib.whatif_matrix_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.whatif_matrix_scratch_floats.restype = ctypes.c_longlong
    lib.whatif_matrix_error_string.argtypes = [ctypes.c_int]
    lib.whatif_matrix_error_string.restype = ctypes.c_char_p


def _whatif_cuda(x: TickInputs) -> torch.Tensor:
    """Launch `csrc/whatif_matrix.cu` on tensors on one CUDA device."""
    jn, n, r, s = _window(x, "whatif_matrix")
    dev = x.d.device
    f32 = torch.float32
    _lib.check_tensor(x.bw, "bw", (jn, n, r, s), f32, dev, contiguous=False)
    for name in ("amax", "second", "relprev"):
        _lib.check_tensor(getattr(x, name), name, (jn, n, s), f32, dev)
    _lib.check_tensor(x.leader, "leader", (jn, n, s), torch.int32, dev)
    _lib.check_tensor(x.sync, "sync", (s,), torch.uint8, dev)
    wmin = x.d
    if x.sync_stages:
        _lib.check_tensor(x.wmin, "wmin", (jn, n, s), f32, dev)
        wmin = x.wmin
    lib = _lib.load_library("whatif_matrix.cu", _bind_whatif, CSRC, NVCC_FLAGS)
    wif = torch.empty((jn, s, r), dtype=f32, device=dev)
    # the cell walk's segment sums past 32 stages (the library's count)
    scratch = lib.whatif_matrix_scratch_floats(jn, n, r, s)
    seg = torch.empty((scratch,), dtype=f32, device=dev) if scratch else None
    with torch.cuda.device(dev):
        rc = lib.whatif_matrix_launch(
            x.d.data_ptr(), wmin.data_ptr(), x.bw.data_ptr(),
            x.amax.data_ptr(), x.second.data_ptr(), x.leader.data_ptr(),
            x.relprev.data_ptr(), x.sync.data_ptr(),
            0 if seg is None else seg.data_ptr(), wif.data_ptr(),
            _strides(x.bw), jn, n, r, s, _stream(dev),
        )
    _raise_on(rc, lib, "whatif_matrix")
    _lib.count_launch(launches, "whatif_matrix")
    return wif


def _whatif_plain(x: TickInputs) -> torch.Tensor:
    """The what-if kernel's function in plain torch, steps in order."""
    d = x.d
    jn, n, r, s = d.shape
    ranks = torch.arange(r, dtype=torch.int32, device=d.device).view(1, 1, r, 1)
    w = imputed_work(d, x.sync_stages, x.wmin)
    ew = torch.clamp_min(ftz(w - x.bw), 0.0)
    arr = ftz(
        x.relprev[:, :, None] + segment_arrivals(stage_prefix(w), x.sync_stages)
    )
    amax = x.amax[:, :, None]
    other = torch.where(ranks == x.leader[:, :, None], x.second[:, :, None], amax)
    contrib = torch.clamp_min(
        ftz(amax - torch.maximum(other, ftz(arr - ew))), 0.0
    )
    wacc = torch.zeros((jn, r, s), dtype=torch.float32, device=d.device)
    for t in range(n):
        wacc = ftz(wacc + contrib[:, t])
    return wacc.permute(0, 2, 1).contiguous()


def whatif_matrix_kernel(x: TickInputs) -> torch.Tensor:
    """[J, S, R] recoverable seconds of clipping each (stage, rank) cell
    of the window `x.d` to `x.bw`, summed over the steps in step order,
    from the prolog's boundary stats: one launch on CUDA."""
    return _dispatch(x, _whatif_cuda, _whatif_plain)


# ---------------------------------------------------------------------------
# kernel 4: the regime family
# ---------------------------------------------------------------------------


def _bind_regimes(lib: ctypes.CDLL) -> None:
    """Declare the C interface of `csrc/regime_stats.cu`."""
    lib.regime_stats_launch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.regime_stats_launch.restype = ctypes.c_int
    lib.regime_stats_error_string.argtypes = [ctypes.c_int]
    lib.regime_stats_error_string.restype = ctypes.c_char_p


def _regime_cuda(x: TickInputs) -> tuple[torch.Tensor, ...]:
    """Launch `csrc/regime_stats.cu` on tensors on one CUDA device."""
    jn, n, r, s = _window(x, "regime_stats")
    dev = x.d.device
    f32, i32 = torch.float32, torch.int32
    _lib.check_tensor(x.bw, "bw", (jn, n, r, s), f32, dev, contiguous=False)
    if x.thr is None:
        raise ValueError("the regime kernel needs the prolog's threshold")
    _lib.check_tensor(x.thr, "thr", (jn, r, s), f32, dev)
    _lib.check_tensor(x.sync, "sync", (s,), torch.uint8, dev)
    wmin = x.d
    if x.sync_stages:
        _lib.check_tensor(x.wmin, "wmin", (jn, n, s), f32, dev)
        wmin = x.wmin
    lib = _lib.load_library("regime_stats.cu", _bind_regimes, CSRC, NVCC_FLAGS)
    out = tuple(torch.empty((jn, s, r), dtype=i32, device=dev) for _ in range(5))
    out += tuple(torch.empty((jn, s, r), dtype=f32, device=dev) for _ in range(2))
    with torch.cuda.device(dev):
        rc = lib.regime_stats_launch(
            x.d.data_ptr(), wmin.data_ptr(), x.bw.data_ptr(),
            x.thr.data_ptr(), x.sync.data_ptr(), *(t.data_ptr() for t in out),
            _strides(x.bw), jn, n, r, s, _stream(dev),
        )
    _raise_on(rc, lib, "regime_stats")
    _lib.count_launch(launches, "regime_stats")
    return out


def _regime_plain(x: TickInputs) -> tuple[torch.Tensor, ...]:
    """The regime kernel's function in plain torch, steps in order."""
    jn, n, r, s = x.d.shape
    dev = x.d.device
    ew = _excess(x)
    act = ew > x.thr[:, None]
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
    return tuple(
        v.permute(0, 2, 1).contiguous()
        for v in (count, onset, last, runs, streak, sume, sumpfx)
    )


def regime_stats_kernel(x: TickInputs) -> tuple[torch.Tensor, ...]:
    """(count, onset, last, runs, streak, sum_e, sum_pfx), each [J, S, R]
    (onset BIG = never), of the activity `e > x.thr` of the window's
    exposed increments: one launch on CUDA."""
    return _dispatch(x, _regime_cuda, _regime_plain)
