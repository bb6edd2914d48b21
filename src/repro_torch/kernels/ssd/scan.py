"""The SSD chunked scan on the card: the hand-written kernels of
``csrc/ssd_scan.cu`` and the plain PyTorch version of their arithmetic.

`ssd_scan` computes what `models.ssm._ssd` computes, for CUDA tensors:
from xh [B, S, H, P] (the conv's x, read at its strides), dt [B, S, H]
(after the softplus), a and D [H], and the one group's B and C [B, S, N]
(read at their strides), y [B, S, H, P] in f32 with the D term added, in
chunks of Q tokens.  Values and sums are f32: the chunk kernel's products
are f32 FMA, and the output and backward kernels' products run on the
tensor cores with each f32 operand as three bf16 parts whose sum it is
(`kernels.attention.split_parts`).

Three launches forward: the chunk kernel (each chunk's within-chunk
cumulative sum of dt * a, its state [N, P] and the chunk's C.B^T, shared
by the heads), the state pass (the state entering each chunk, a walk over
the chunks) and the output kernel (the masked decays and the scores formed
tile by tile on chip, the product with the dt-weighted x, the entering
state's share and the D term).  When a gradient is wanted the entering
states are kept, and the backward is four launches: the chunk kernel
again (C.B^T, the cumulative sums, and each chunk's gradient of its
entering state), the state pass in reverse, one kernel a (batch, chunk,
head) for the gradients of x, dt, and that head's shares of B, C, a and
D, and a reduction of the shares in a fixed order: no atomics, so two runs
agree bit for bit.  One library per (P, N) is built on first use.

`ssd_scan_ref` is the kernels' arithmetic in plain PyTorch on any device:
the same chunk states, state pass, tiles and hand-written backward, as a
`torch.autograd.Function`, its products in the inputs' dtype.  The tests hold it against autograd through
`_ssd` on the CPU, and the kernel against it and `_ssd` on the card.  No
model path calls it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .. import _lib

__all__ = [
    "INSTANCES",
    "launches",
    "library_flags",
    "ssd_scan",
    "ssd_scan_ref",
]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCE = "ssd_scan.cu"
#: the (head_dim P, state N) a library is built for: hymba-1.5b,
#: mamba2-130m and the reduced configs
INSTANCES = ((64, 16), (64, 128), (16, 16))
#: chunk lengths the kernels take: any that divides the sequence, up to this
MAX_CHUNK = 256
#: launches of each kernel, counted by `_lib.count_launch`
launches = {"forward_chunk": 0, "forward_state": 0, "forward_output": 0,
            "backward_chunk": 0, "backward_state": 0, "backward_main": 0,
            "backward_reduce": 0}


def library_flags(head_dim: int, state: int) -> tuple[str, ...]:
    """nvcc flags of the (P, N) instance: no ``-ftz=true`` and no fast
    math, so exp keeps its subnormals as the plain version's does."""
    return (*_lib.NVCC_ARCH_FLAGS, f"-DSSD_P={head_dim}", f"-DSSD_N={state}")


def _bind(lib) -> None:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    shape = [i, i, i, i] + [q] * 7  # B, S, H, Q; x, B and C strides
    lib.ssd_chunk.argtypes = [p] * 10 + shape + [p]
    lib.ssd_state_pass.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.ssd_output.argtypes = [p] * 8 + shape + [p]
    lib.ssd_backward.argtypes = [p] * 18 + shape + [p]
    lib.ssd_reduce.argtypes = [p] * 8 + [i] * 5 + [p]
    for name in ("ssd_chunk", "ssd_state_pass", "ssd_output", "ssd_backward", "ssd_reduce"):
        getattr(lib, name).restype = i
    lib.ssd_error_string.argtypes = [i]
    lib.ssd_error_string.restype = ctypes.c_char_p


@functools.cache
def _library(head_dim: int, state: int):
    return _lib.load_library(_SOURCE, _bind, csrc=CSRC, flags=library_flags(head_dim, state))


def _check(xh, dt, a, d, b_, c_, q: int) -> None:
    """Raise unless the kernels take these inputs, naming why not."""
    named = (("xh", xh), ("dt", dt), ("a", a), ("d", d), ("b", b_), ("c", c_))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} is on {t.device}, not a CUDA device")
        if t.device != xh.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, xh on {xh.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: {name} has dtype {t.dtype}; the scan is f32")
    _check_shape(xh, dt, a, d, b_, c_, q)


def _check_shape(xh, dt, a, d, b_, c_, q: int) -> None:
    """Raise unless the kernels have an instance for these shapes and this
    chunk, and read the inputs' strides."""
    named = (("xh", xh), ("dt", dt), ("a", a), ("d", d), ("b", b_), ("c", c_))
    if xh.dim() != 4:
        raise ValueError(f"ssd_scan: xh has shape {tuple(xh.shape)}, not [B, S, H, P]")
    b, s, h, p = xh.shape
    n = b_.shape[-1]
    if (p, n) not in INSTANCES:
        raise ValueError(f"ssd_scan: (head_dim, state) ({p}, {n}) is not one of {INSTANCES}")
    want = {"dt": (b, s, h), "a": (h,), "d": (h,), "b": (b, s, n), "c": (b, s, n)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]} beside xh {tuple(xh.shape)}")
    if not 1 <= q <= MAX_CHUNK or s % q:
        raise ValueError(f"ssd_scan: chunk {q} over {s} tokens: the kernels take chunks of 1 "
                         f"to {MAX_CHUNK} positions that divide the sequence")
    if xh.stride(3) != 1 or b_.stride(2) != 1 or c_.stride(2) != 1:
        raise ValueError("ssd_scan: xh, b and c must be contiguous in their last dim")


def _shape_args(xh, b_, c_, q):
    b, s, h, _ = xh.shape
    return [b, s, h, q, xh.stride(0), xh.stride(1), xh.stride(2),
            b_.stride(0), b_.stride(1), c_.stride(0), c_.stride(1)]


def _raise(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"ssd_scan {what} launch failed: "
                           f"{lib.ssd_error_string(err).decode()}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _chunk(lib, xh, dt, a, b_, c_, dy, q, stream, key):
    """The chunk kernel: (each chunk's state [B, NC, H, N, P] -- its own
    input's, or with `dy` its entering state's gradient -- C.B^T [B, NC,
    Q, Q], the within-chunk cumulative sums [B, H, S] (f64 sums rounded
    once), their totals [B,
    NC, H])."""
    b, s, h, p = xh.shape
    n, nc = b_.shape[-1], s // q
    f32 = dict(dtype=torch.float32, device=xh.device)
    st = torch.empty((b, nc, h, n, p), **f32)
    g = torch.empty((b, nc, q, q), **f32)
    cum = torch.empty((b, h, s), **f32)
    tot = torch.empty((b, nc, h), **f32)
    err = lib.ssd_chunk(xh.data_ptr(), dt.data_ptr(), a.data_ptr(), b_.data_ptr(),
                        c_.data_ptr(), _ptr(dy), st.data_ptr(), g.data_ptr(), cum.data_ptr(),
                        tot.data_ptr(), *_shape_args(xh, b_, c_, q), stream)
    _raise(lib, err, key)
    _lib.count_launch(launches, key)
    return st, g, cum, tot


def _state_pass(lib, states, tot, reverse: bool, stream, key):
    """The walk over the chunks: out[c] the carry before chunk c, then
    carry = states[c] + exp(tot[c]) * carry, from the first chunk (the
    entering states) or, `reverse`, from the last (their gradients)."""
    b, nc, h, n, p = states.shape
    out = torch.empty_like(states)
    err = lib.ssd_state_pass(states.data_ptr(), tot.data_ptr(), out.data_ptr(), int(reverse),
                             b, nc, h, stream)
    _raise(lib, err, key)
    _lib.count_launch(launches, key)
    return out


def _forward(xh, dt, a, d, b_, c_, q: int):
    """y and the state entering each chunk [B, NC, H, N, P]."""
    lib = _library(xh.shape[3], b_.shape[-1])
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    st, g, cum, tot = _chunk(lib, xh, dt, a, b_, c_, None, q, stream, "forward_chunk")
    hin = _state_pass(lib, st, tot, False, stream, "forward_state")
    del st
    y = torch.empty(xh.shape, dtype=torch.float32, device=xh.device)
    err = lib.ssd_output(xh.data_ptr(), dt.data_ptr(), d.data_ptr(), c_.data_ptr(),
                         g.data_ptr(), cum.data_ptr(), hin.data_ptr(), y.data_ptr(),
                         *_shape_args(xh, b_, c_, q), stream)
    _raise(lib, err, "forward_output")
    _lib.count_launch(launches, "forward_output")
    return y, hin


def _backward(xh, dt, a, d, b_, c_, hin, dy, q: int):
    """The gradients of (xh, dt, a, d, b, c) from dy [B, S, H, P]
    (contiguous) and the saved entering states."""
    lib = _library(xh.shape[3], b_.shape[-1])
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    b, s, h, p = xh.shape
    n, nc = b_.shape[-1], s // q
    dh, g, cum, tot = _chunk(lib, xh, dt, a, b_, c_, dy, q, stream, "backward_chunk")
    ds = _state_pass(lib, dh, tot, True, stream, "backward_state")
    del dh
    f32 = dict(dtype=torch.float32, device=xh.device)
    dx = torch.empty((b, s, h, p), **f32)
    ddt = torch.empty((b, s, h), **f32)
    dbp = torch.empty((b, s, h, n), **f32)
    dcp = torch.empty((b, s, h, n), **f32)
    dap = torch.empty((b, nc, h), dtype=torch.float64, device=xh.device)
    ddp = torch.empty_like(dap)
    err = lib.ssd_backward(xh.data_ptr(), dt.data_ptr(), a.data_ptr(), d.data_ptr(),
                           b_.data_ptr(), c_.data_ptr(), dy.data_ptr(), g.data_ptr(),
                           cum.data_ptr(), tot.data_ptr(), hin.data_ptr(), ds.data_ptr(),
                           dx.data_ptr(), ddt.data_ptr(), dbp.data_ptr(), dcp.data_ptr(),
                           dap.data_ptr(), ddp.data_ptr(), *_shape_args(xh, b_, c_, q), stream)
    _raise(lib, err, "backward_main")
    _lib.count_launch(launches, "backward_main")
    del g, cum, ds
    db, dc = torch.empty((b, s, n), **f32), torch.empty((b, s, n), **f32)
    da, dd = torch.empty((h,), **f32), torch.empty((h,), **f32)
    err = lib.ssd_reduce(dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(), ddp.data_ptr(),
                         db.data_ptr(), dc.data_ptr(), da.data_ptr(), dd.data_ptr(),
                         b, s, h, n, nc, stream)
    _raise(lib, err, "backward_reduce")
    _lib.count_launch(launches, "backward_reduce")
    return dx, ddt, da, dd, db, dc


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, dt, a, d, b_, c_, q):
        y, hin = _forward(xh, dt, a, d, b_, c_, q)
        ctx.save_for_backward(xh, dt, a, d, b_, c_, hin)
        ctx.q = q
        return y

    @staticmethod
    def backward(ctx, dy):
        xh, dt, a, d, b_, c_, hin = ctx.saved_tensors
        grads = _backward(xh, dt, a, d, b_, c_, hin, dy.float().contiguous(), ctx.q)
        return (*grads, None)


def ssd_scan(xh, dt, a, d, b_, c_, q: int) -> torch.Tensor:
    """The kernels: `models.ssm._ssd` of xh [B, S, H, P], dt [B, S, H], a
    and d [H], b_ and c_ [B, S, N] in chunks of `q`, on a CUDA device.
    Raises, with the reason, for inputs the kernels do not take."""
    _check(xh, dt, a, d, b_, c_, q)
    dt, a, d = dt.contiguous(), a.contiguous(), d.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xh, dt, a, d, b_, c_)):
        return _SsdScan.apply(xh, dt, a, d, b_, c_, q)
    return _forward(xh, dt, a, d, b_, c_, q)[0]


# ---------------------------------------------------------------------------
# the plain version of the kernels' arithmetic

#: the kernels' tile of a chunk's positions at N <= 64 (at N = 128: 32)
REF_TILE = 64


def _chunked(xh, dt, a, b_, c_, q):
    """Chunk-major views: x [B, NC, H, Q, P], dt [B, NC, H, Q], B and C
    [B, NC, Q, N]; the within-chunk cumulative sums [B, NC, H, Q] (summed
    in f64 and rounded once to the inputs' dtype, as the kernels' are) and
    C.B^T [B, NC, Q, Q]."""
    b, s, h, p = xh.shape
    n, nc = b_.shape[-1], s // q
    x = xh.reshape(b, nc, q, h, p).transpose(2, 3)
    dtc = dt.reshape(b, nc, q, h).transpose(2, 3)
    bc, cc = b_.reshape(b, nc, q, n), c_.reshape(b, nc, q, n)
    cum = torch.cumsum(dtc.double() * a.double()[:, None], dim=-1).to(xh.dtype)
    return x, dtc, bc, cc, cum, cc @ bc.transpose(-1, -2)


def _walk(states, tot, reverse: bool):
    """The state pass: out[c] the carry before chunk c."""
    out = torch.empty_like(states)
    carry = torch.zeros_like(states[:, 0])
    order = range(states.shape[1] - 1, -1, -1) if reverse else range(states.shape[1])
    for c in order:
        out[:, c] = carry
        carry = states[:, c] + torch.exp(tot[:, c])[..., None, None] * carry
    return out


def _tiles(q: int, tile: int):
    return [slice(t, min(t + tile, q)) for t in range(0, q, tile)]


def _decays(cum, g, rows: slice, cols: slice):
    """The masked decays L [B, NC, H, |rows|, |cols|] and G * L over a
    tile: exp of the difference of cumulative sums where j <= i, else 0,
    masked before the exp."""
    i = torch.arange(rows.start, rows.stop, device=cum.device)
    j = torch.arange(cols.start, cols.stop, device=cum.device)
    vis = j[None, :] <= i[:, None]
    seg = cum[..., rows, None] - cum[..., None, cols]
    decay = torch.where(vis, torch.exp(torch.where(vis, seg, torch.zeros_like(seg))),
                        torch.zeros_like(seg))
    return decay, g[:, :, None, rows, cols] * decay


class _SsdScanRef(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, dt, a, d, b_, c_, q, tile):
        b, s, h, p = xh.shape
        x, dtc, bc, cc, cum, g = _chunked(xh, dt, a, b_, c_, q)
        xd = x * dtc[..., None]
        w = dtc * torch.exp(cum[..., -1:] - cum)
        states = torch.einsum("bcjn,bchj,bchjp->bchnp", bc, w, x)   # [B,NC,H,N,P]
        hin = _walk(states, cum[..., -1], False)
        y = torch.empty_like(x)
        for rows in _tiles(q, tile):
            acc = torch.einsum("bcin,bchnp->bchip", cc[:, :, rows], hin)
            acc = acc * torch.exp(cum[..., rows])[..., None]
            for cols in _tiles(q, tile):
                if cols.start < rows.stop:
                    acc = acc + _decays(cum, g, rows, cols)[1] @ xd[..., cols, :]
            y[..., rows, :] = acc
        y = y + d[:, None, None] * x
        ctx.save_for_backward(xh, dt, a, d, b_, c_, hin)
        ctx.q, ctx.tile = q, tile
        return y.transpose(2, 3).reshape(b, s, h, p)

    @staticmethod
    def backward(ctx, dy):
        xh, dt, a, d, b_, c_, hin = ctx.saved_tensors
        q, tile = ctx.q, ctx.tile
        b, s, h, p = xh.shape
        x, dtc, bc, cc, cum, g = _chunked(xh, dt, a, b_, c_, q)
        dyc = dy.reshape(b, s // q, q, h, p).transpose(2, 3)
        xd = x * dtc[..., None]
        e = torch.exp(cum)
        # the chunk kernel again, then the state pass in reverse
        dh = torch.einsum("bcin,bchi,bchip->bchnp", cc, e, dyc)
        ds = _walk(dh, cum[..., -1], True)
        # the main kernel: the entering states' share, then the tiles
        dcp = torch.einsum("bchip,bchnp->bchin", dyc, hin) * e[..., None]
        dcum_r = (cc[:, :, None] * dcp).sum(-1)
        dcum_c = torch.zeros_like(dcum_r)
        dxd, dbp = torch.zeros_like(x), torch.zeros_like(dcp)
        to_end = torch.exp(cum[..., -1:] - cum)
        for cols in _tiles(q, tile):
            for rows in _tiles(q, tile):
                if cols.start >= rows.stop:
                    continue
                decay, m0 = _decays(cum, g, rows, cols)
                dm0 = dyc[..., rows, :] @ xd[..., cols, :].transpose(-1, -2)
                dg, dseg = dm0 * decay, dm0 * m0
                dcum_r[..., rows] += dseg.sum(-1)
                dcum_c[..., cols] += dseg.sum(-2)
                dxd[..., cols, :] += m0.transpose(-1, -2) @ dyc[..., rows, :]
                dbp[..., cols, :] += dg.transpose(-1, -2) @ cc[:, :, None, rows]
                dcp[..., rows, :] += dg @ bc[:, :, None, cols]
            # the chunk state's share of this tile of positions
            bj = bc[:, :, None, cols] * to_end[..., cols, None]
            dxd[..., cols, :] += bj @ ds
            z = xd[..., cols, :] @ ds.transpose(-1, -2)
            dbp[..., cols, :] += z * to_end[..., cols, None]
            wj = (bj * z).sum(-1)
            dcum_c[..., cols] += wj
            dcum_r[..., -1] += wj.sum(-1)
        dcum_r[..., -1] += torch.exp(cum[..., -1]) * (hin * ds).sum((-1, -2))
        dcum = dcum_r - dcum_c
        dda = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
        ddt = (x * dxd).sum(-1) + a[:, None] * dda
        dx = d[:, None, None] * dyc + dtc[..., None] * dxd
        da = (dtc * dda).sum((0, 1, 3))
        dd = (dyc * x).sum((0, 1, 3, 4))

        def unchunk(t):
            return t.transpose(2, 3).reshape(b, s, h, *t.shape[4:])

        return (unchunk(dx), unchunk(ddt), da, dd, unchunk(dbp).sum(2), unchunk(dcp).sum(2),
                None, None)


def ssd_scan_ref(xh, dt, a, d, b_, c_, q: int, tile: int = REF_TILE) -> torch.Tensor:
    """`ssd_scan`'s arithmetic in plain PyTorch, on any device, with tiles
    of `tile` positions: the chunk states, the state pass, the output's
    tiles and the hand-written backward."""
    return _SsdScanRef.apply(xh, dt, a, d, b_, c_, q, tile)
