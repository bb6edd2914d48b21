"""The SSD mixer's elementwise chains on the card: the hand-written kernels
of ``csrc/ssd_mixer.cu`` and the plain PyTorch version of their arithmetic.

`conv_silu_dt` computes what `models.ssm.apply_ssm` computes between
``in_proj`` and the scan, for CUDA tensors: from ``in_proj``'s output zx
[B, S, 2D + 2N + H] (z, x, B, C, dt; read at its strides), the depthwise
causal conv of x, B and C (width W <= 4, f32 products and sums, each row
from zeros) with its bias and silu, as three contiguous f32 tensors x [B,
S, D], B and C [B, S, N], and dt's softplus of dt + dt_bias [B, S, H]: one
launch.  Its backward is one launch that writes the gradients of x, B, C
and dt into zx's gradient and per-CTA partial sums of the conv's weight,
bias and dt_bias gradients, then a reduction in a fixed order.

`gated_rms_norm` computes the gated RMS norm after the scan: from y [B, S,
D] f32 and z (zx's first D columns), y silu(z) normalised over D (eps
1e-6) times the scale, in zx's dtype (``out_proj``'s operand), one launch
that keeps each row's reciprocal RMS.  Its backward is one launch (dy in
f32, dz into zx's gradient, partial sums of the scale's gradient), then
the reduction.

The gradient of zx is one [B, S, L] tensor that both backwards fill when
the two calls share a `ProjGrad` (`apply_ssm` passes one): the norm's
backward, which runs first, allocates it and writes z's columns, the
conv's writes the rest and returns it whole; nothing is zero-filled or
added.  Without one, each returns a zero-filled tensor with its own
columns written.  No atomics: two runs agree bit for bit.  One library is
built on first use.

`conv_silu_dt_ref` and `gated_rms_norm_ref` are the kernels' arithmetic in
plain PyTorch on any device, with the hand-written backwards, as
`torch.autograd.Function`s: in f32, or in the inputs' dtype where that is
wider.  The tests hold them against autograd through the plain model
code on the CPU, and the kernels against them on the card.  No model path
calls them.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch
import torch.nn.functional as F

from .. import _lib

__all__ = [
    "MAX_WIDTH",
    "ProjGrad",
    "conv_silu_dt",
    "conv_silu_dt_ref",
    "gated_rms_norm",
    "gated_rms_norm_ref",
    "launches",
]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCE = "ssd_mixer.cu"
#: the widest causal conv the kernels take
MAX_WIDTH = 4
#: the norm's epsilon, as `models.ssm._gated_norm`'s
EPS = 1e-6
#: launches of each kernel, counted by `_lib.count_launch`
launches = {"conv_forward": 0, "conv_backward": 0, "conv_reduce": 0,
            "norm_forward": 0, "norm_backward": 0, "norm_reduce": 0}


def library_flags() -> tuple[str, ...]:
    """nvcc flags: no ``-ftz=true`` and no fast math, so exp and the
    division keep the plain version's rounding."""
    return _lib.NVCC_ARCH_FLAGS


def _bind(lib) -> None:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mixer_conv_forward.argtypes = [p, q, q] + [p] * 7 + [i] * 8 + [p]
    lib.mixer_conv_backward.argtypes = [p, q, q] + [p] * 9 + [i] * 8 + [p]
    lib.mixer_conv_reduce.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.mixer_norm_forward.argtypes = [p, p, q, q] + [p] * 3 + [i] * 5 + [p]
    lib.mixer_norm_backward.argtypes = [p, p, q, q] + [p] * 5 + [q, p] + [i] * 5 + [p]
    lib.mixer_norm_reduce.argtypes = [p, p] + [i] * 3 + [p]
    for name in ("mixer_conv_forward", "mixer_conv_backward", "mixer_conv_reduce",
                 "mixer_norm_forward", "mixer_norm_backward", "mixer_norm_reduce",
                 "mixer_conv_blocks", "mixer_norm_blocks"):
        getattr(lib, name).restype = i
    lib.mixer_conv_blocks.argtypes = [i, i]
    lib.mixer_norm_blocks.argtypes = [i, i]
    lib.mixer_error_string.argtypes = [i]
    lib.mixer_error_string.restype = ctypes.c_char_p


@functools.cache
def _library():
    return _lib.load_library(_SOURCE, _bind, csrc=CSRC, flags=library_flags())


class ProjGrad:
    """The gradient of ``in_proj``'s output that one mixer call's two
    backwards fill in turn: the norm's leaves it here, the conv's takes it."""

    __slots__ = ("grad",)

    def __init__(self):
        self.grad = None


# ---------------------------------------------------------------------------
# checks


def _check_device(name: str, tensors) -> None:
    device = tensors[0][1].device
    for arg, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not a CUDA device")
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, {tensors[0][0]} on {device}")


def _check_dtypes(name: str, zx, named, dt_bias=None) -> None:
    if zx.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: zx has dtype {zx.dtype}; the kernels take bfloat16 or float32")
    for arg, t in named:
        if t.dtype != zx.dtype:
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, zx {zx.dtype}")
    if dt_bias is not None and dt_bias.dtype != torch.float32:
        raise ValueError(f"{name}: dt_bias has dtype {dt_bias.dtype}; it is float32")


def _check_conv_shape(zx, conv_w, conv_b, dt_bias, d_inner: int, state: int) -> None:
    """Raise unless the conv kernels take these shapes: zx [B, S, 2D + 2N +
    H] with its last dim contiguous, conv_w [W, D + 2N] of width 1 to
    `MAX_WIDTH`, conv_b [D + 2N], dt_bias [H]."""
    if zx.dim() != 3 or zx.stride(-1) != 1:
        raise ValueError(f"conv_silu_dt: zx has shape {tuple(zx.shape)} and strides "
                         f"{zx.stride()}; it is [B, S, L] with its last dim contiguous")
    channels = d_inner + 2 * state
    heads = zx.shape[-1] - d_inner - channels
    if d_inner < 1 or state < 1 or heads < 1:
        raise ValueError(f"conv_silu_dt: zx's {zx.shape[-1]} columns hold no z, x, B, C "
                         f"(d_inner {d_inner}, state {state}) and dt")
    if conv_w.dim() != 2 or not 1 <= conv_w.shape[0] <= MAX_WIDTH:
        raise ValueError(f"conv_silu_dt: conv_w has shape {tuple(conv_w.shape)}: the kernels "
                         f"take conv widths 1 to {MAX_WIDTH}, not width {conv_w.shape[0]}")
    want = {"conv_w": (conv_w.shape[0], channels), "conv_b": (channels,), "dt_bias": (heads,)}
    for name, t in (("conv_w", conv_w), ("conv_b", conv_b), ("dt_bias", dt_bias)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"conv_silu_dt: {name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]} beside zx {tuple(zx.shape)}")


def _check_norm_shape(y, zx, scale) -> None:
    """Raise unless the norm kernels take these shapes: y [B, S, D], zx [B,
    S, L >= D] with its last dim contiguous, scale [D]."""
    if y.dim() != 3 or zx.dim() != 3 or zx.stride(-1) != 1:
        raise ValueError(f"gated_rms_norm: y {tuple(y.shape)} and zx {tuple(zx.shape)} "
                         f"(strides {zx.stride()}) are [B, S, D] and [B, S, L], zx's last "
                         f"dim contiguous")
    d = y.shape[-1]
    if zx.shape[:2] != y.shape[:2] or zx.shape[-1] < d or tuple(scale.shape) != (d,):
        raise ValueError(f"gated_rms_norm: y {tuple(y.shape)}, zx {tuple(zx.shape)} and scale "
                         f"{tuple(scale.shape)} do not fit")


def _pairs(*tensors, widths=()) -> int:
    """2 where every width and stride is even and every tensor aligned to
    two elements, so the kernels load and store pairs; else 1."""
    even = all(w % 2 == 0 for w in widths)
    even = even and all(s % 2 == 0 for t in tensors for s in t.stride()[:-1])
    aligned = all(t.data_ptr() % (2 * t.element_size()) == 0 for t in tensors)
    return 2 if even and aligned else 1


def _raise(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"ssd mixer {what} launch failed: "
                           f"{lib.mixer_error_string(err).decode()}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# the launches


def _conv_forward(zx, conv_w, conv_b, dt_bias, d_inner: int, state: int):
    """(x [B, S, D], B, C [B, S, N], dt [B, S, H]) in f32."""
    lib = _library()
    b, s, width = zx.shape
    heads = width - 2 * (d_inner + state)
    f32 = dict(dtype=torch.float32, device=zx.device)
    x, b_, c_ = (torch.empty((b, s, w), **f32) for w in (d_inner, state, state))
    dt = torch.empty((b, s, heads), **f32)
    vec = _pairs(zx, widths=(d_inner, state, width))
    err = lib.mixer_conv_forward(
        zx.data_ptr(), zx.stride(0), zx.stride(1), conv_w.data_ptr(), conv_b.data_ptr(),
        dt_bias.data_ptr(), x.data_ptr(), b_.data_ptr(), c_.data_ptr(), dt.data_ptr(), b, s,
        d_inner, state, heads, conv_w.shape[0], int(zx.dtype == torch.bfloat16), vec,
        _stream(zx))
    _raise(lib, err, "conv_forward")
    _lib.count_launch(launches, "conv_forward")
    return x, b_, c_, dt


def _conv_backward(zx, conv_w, conv_b, dt_bias, d_inner: int, state: int, gx, gb, gc, gdt,
                   dzx):
    """Fill x's, B's, C's and dt's columns of `dzx` (contiguous, zx's shape
    and dtype); returns the gradients of conv_w, conv_b and dt_bias."""
    lib = _library()
    b, s, width = zx.shape
    heads = width - 2 * (d_inner + state)
    w, channels = conv_w.shape
    blocks = lib.mixer_conv_blocks(b, s)
    part = torch.empty((blocks, (w + 1) * channels + heads), dtype=torch.float32,
                       device=zx.device)
    vec = _pairs(zx, widths=(d_inner, state, width))
    bf16 = int(zx.dtype == torch.bfloat16)
    stream = _stream(zx)
    err = lib.mixer_conv_backward(
        zx.data_ptr(), zx.stride(0), zx.stride(1), conv_w.data_ptr(), conv_b.data_ptr(),
        dt_bias.data_ptr(), gx.data_ptr(), gb.data_ptr(), gc.data_ptr(), gdt.data_ptr(),
        dzx.data_ptr(), part.data_ptr(), b, s, d_inner, state, heads, w, bf16, vec, stream)
    _raise(lib, err, "conv_backward")
    _lib.count_launch(launches, "conv_backward")
    dw, db, ddt_bias = torch.empty_like(conv_w), torch.empty_like(conv_b), torch.empty_like(dt_bias)
    err = lib.mixer_conv_reduce(part.data_ptr(), dw.data_ptr(), db.data_ptr(),
                                ddt_bias.data_ptr(), blocks, channels, heads, w, bf16, stream)
    _raise(lib, err, "conv_reduce")
    _lib.count_launch(launches, "conv_reduce")
    return dw, db, ddt_bias


def _norm_forward(y, zx, scale):
    """(the norm in zx's dtype [B, S, D], each row's reciprocal RMS [B, S])."""
    lib = _library()
    b, s, d = y.shape
    out = torch.empty((b, s, d), dtype=zx.dtype, device=zx.device)
    rstd = torch.empty((b, s), dtype=torch.float32, device=zx.device)
    vec = _pairs(zx, y, widths=(d, zx.shape[-1]))
    err = lib.mixer_norm_forward(y.data_ptr(), zx.data_ptr(), zx.stride(0), zx.stride(1),
                                 scale.data_ptr(), out.data_ptr(), rstd.data_ptr(), b, s, d,
                                 int(zx.dtype == torch.bfloat16), vec, _stream(zx))
    _raise(lib, err, "norm_forward")
    _lib.count_launch(launches, "norm_forward")
    return out, rstd


def _norm_backward(y, zx, scale, rstd, g, dzx):
    """dy [B, S, D] f32 and scale's gradient; z's columns of `dzx`
    (contiguous, zx's shape and dtype) filled."""
    lib = _library()
    b, s, d = y.shape
    blocks = lib.mixer_norm_blocks(b, s)
    part = torch.empty((blocks, d), dtype=torch.float32, device=zx.device)
    dy = torch.empty((b, s, d), dtype=torch.float32, device=zx.device)
    vec = _pairs(zx, y, g, widths=(d, zx.shape[-1]))
    bf16 = int(zx.dtype == torch.bfloat16)
    stream = _stream(zx)
    err = lib.mixer_norm_backward(y.data_ptr(), zx.data_ptr(), zx.stride(0), zx.stride(1),
                                  scale.data_ptr(), rstd.data_ptr(), g.data_ptr(), dy.data_ptr(),
                                  dzx.data_ptr(), dzx.stride(1), part.data_ptr(), b, s, d, bf16,
                                  vec, stream)
    _raise(lib, err, "norm_backward")
    _lib.count_launch(launches, "norm_backward")
    dscale = torch.empty_like(scale)
    err = lib.mixer_norm_reduce(part.data_ptr(), dscale.data_ptr(), blocks, d, bf16, stream)
    _raise(lib, err, "norm_reduce")
    _lib.count_launch(launches, "norm_reduce")
    return dy, dscale


# ---------------------------------------------------------------------------
# autograd


def _take_grad(link, zx):
    """The gradient of zx that `link` holds (taken from it), else a new
    zero-filled one."""
    grad = None
    if link is not None:
        grad, link.grad = link.grad, None
    return torch.zeros(zx.shape, dtype=zx.dtype, device=zx.device) if grad is None else grad


class _ConvSiluDt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, zx, conv_w, conv_b, dt_bias, d_inner, state, link):
        ctx.save_for_backward(zx, conv_w, conv_b, dt_bias)
        ctx.dims, ctx.link = (d_inner, state), link
        return _conv_forward(zx, conv_w, conv_b, dt_bias, d_inner, state)

    @staticmethod
    def backward(ctx, gx, gb, gc, gdt):
        zx, conv_w, conv_b, dt_bias = ctx.saved_tensors
        dzx = _take_grad(ctx.link, zx)
        grads = _conv_backward(zx, conv_w, conv_b, dt_bias, *ctx.dims, gx.contiguous(),
                               gb.contiguous(), gc.contiguous(), gdt.contiguous(), dzx)
        return (dzx, *grads, None, None, None)


class _GatedRmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, zx, scale, link):
        out, rstd = _norm_forward(y, zx, scale)
        ctx.save_for_backward(y, zx, scale, rstd)
        ctx.link = link
        return out

    @staticmethod
    def backward(ctx, g):
        y, zx, scale, rstd = ctx.saved_tensors
        if ctx.link is None:
            dzx = torch.zeros(zx.shape, dtype=zx.dtype, device=zx.device)
        else:
            dzx = torch.empty(zx.shape, dtype=zx.dtype, device=zx.device)
        dy, dscale = _norm_backward(y, zx, scale, rstd, g.contiguous(), dzx)
        if ctx.link is None:
            return dy, dzx, dscale, None
        ctx.link.grad = dzx
        return dy, None, dscale, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def conv_silu_dt(zx, conv_w, conv_b, dt_bias, d_inner: int, state: int,
                 link: ProjGrad | None = None):
    """The kernels: (silu of the causal conv of x, B and C with its bias:
    x [B, S, D], B and C [B, S, N]; softplus(dt + dt_bias) [B, S, H]), all
    f32, from ``in_proj``'s output zx [B, S, 2D + 2N + H] on a CUDA device.
    With `link`, the backward returns zx's gradient with the columns the
    norm's backward wrote into it.  Raises, with the reason, for inputs
    the kernels do not take."""
    _check_device("conv_silu_dt", [("zx", zx), ("conv_w", conv_w), ("conv_b", conv_b),
                                   ("dt_bias", dt_bias)])
    _check_dtypes("conv_silu_dt", zx, [("conv_w", conv_w), ("conv_b", conv_b)], dt_bias)
    _check_conv_shape(zx, conv_w, conv_b, dt_bias, d_inner, state)
    conv_w, conv_b, dt_bias = conv_w.contiguous(), conv_b.contiguous(), dt_bias.contiguous()
    if _wants_grad(zx, conv_w, conv_b, dt_bias):
        return _ConvSiluDt.apply(zx, conv_w, conv_b, dt_bias, d_inner, state, link)
    return _conv_forward(zx, conv_w, conv_b, dt_bias, d_inner, state)


def gated_rms_norm(y, zx, scale, link: ProjGrad | None = None):
    """The kernel: y silu(z) over its RMS over D (eps 1e-6) times `scale`,
    in zx's dtype [B, S, D], from y [B, S, D] f32 and z, the first D
    columns of zx, on a CUDA device.  With `link`, the backward leaves z's
    gradient in it for `conv_silu_dt`'s.  Raises, with the reason, for
    inputs the kernel does not take."""
    _check_device("gated_rms_norm", [("y", y), ("zx", zx), ("scale", scale)])
    if y.dtype != torch.float32:
        raise ValueError(f"gated_rms_norm: y has dtype {y.dtype}; it is float32")
    _check_dtypes("gated_rms_norm", zx, [("scale", scale)])
    _check_norm_shape(y, zx, scale)
    y, scale = y.contiguous(), scale.contiguous()
    if _wants_grad(y, zx, scale):
        return _GatedRmsNorm.apply(y, zx, scale, link)
    return _norm_forward(y, zx, scale)[0]


# ---------------------------------------------------------------------------
# the plain version of the kernels' arithmetic


def _compute_dtype(t) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _silu_grad(v):
    s = torch.sigmoid(v)
    return s * (1 + v * (1 - s))


class _ConvSiluDtRef(torch.autograd.Function):
    @staticmethod
    def forward(ctx, zx, conv_w, conv_b, dt_bias, d_inner, state):
        ctx.save_for_backward(zx, conv_w, conv_b, dt_bias)
        ctx.dims = (d_inner, state)
        pre, dt = _conv_ref_pre(zx, conv_w, conv_b, dt_bias, d_inner)
        x, b_, c_ = torch.split(F.silu(pre), [d_inner, state, state], dim=-1)
        return x, b_, c_, torch.logaddexp(dt, torch.zeros_like(dt))

    @staticmethod
    def backward(ctx, gx, gb, gc, gdt):
        zx, conv_w, conv_b, dt_bias = ctx.saved_tensors
        d_inner, _ = ctx.dims
        ct = _compute_dtype(zx)
        width, channels = conv_w.shape
        s = zx.shape[1]
        pre, dt = _conv_ref_pre(zx, conv_w, conv_b, dt_bias, d_inner)
        gp = torch.cat([gx, gb, gc], dim=-1).to(ct) * _silu_grad(pre)
        # x_u reaches the outputs at u + W - 1 - i through tap i
        ahead = F.pad(gp, (0, 0, 0, width - 1))
        w = conv_w.to(ct)
        dx = sum(w[i] * ahead[:, width - 1 - i:width - 1 - i + s] for i in range(width))
        xp = F.pad(zx[..., d_inner:d_inner + channels].to(ct), (0, 0, width - 1, 0))
        dw = torch.stack([(gp * xp[:, i:i + s]).sum((0, 1)) for i in range(width)])
        ddt = gdt.to(ct) * torch.sigmoid(dt)
        dzx = torch.zeros_like(zx)
        dzx[..., d_inner:d_inner + channels] = dx.to(zx.dtype)
        dzx[..., d_inner + channels:] = ddt.to(zx.dtype)
        return (dzx, dw.to(conv_w.dtype), gp.sum((0, 1)).to(conv_b.dtype),
                ddt.sum((0, 1)).to(dt_bias.dtype), None, None)


def _conv_ref_pre(zx, conv_w, conv_b, dt_bias, d_inner: int):
    """(the conv's pre-activation [B, S, D + 2N], dt + dt_bias [B, S, H]),
    in f32 or wider: from the bias, tap by tap, as the kernel sums."""
    ct = _compute_dtype(zx)
    width, channels = conv_w.shape
    s = zx.shape[1]
    xp = F.pad(zx[..., d_inner:d_inner + channels].to(ct), (0, 0, width - 1, 0))
    w = conv_w.to(ct)
    pre = conv_b.to(ct)
    for i in range(width):
        pre = pre + w[i] * xp[:, i:i + s]
    return pre, zx[..., d_inner + channels:].to(ct) + dt_bias.to(ct)


def conv_silu_dt_ref(zx, conv_w, conv_b, dt_bias, d_inner: int, state: int):
    """`conv_silu_dt`'s arithmetic in plain PyTorch, on any device, with the
    hand-written backward (its sums over tokens in another order)."""
    return _ConvSiluDtRef.apply(zx, conv_w, conv_b, dt_bias, d_inner, state)


class _GatedRmsNormRef(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, zx, scale):
        ct = _compute_dtype(y)
        d = y.shape[-1]
        u = y.to(ct) * F.silu(zx[..., :d].to(ct))
        rstd = 1 / torch.sqrt((u * u).sum(-1, keepdim=True) / d + EPS)
        ctx.save_for_backward(y, zx, scale, rstd)
        return (u * rstd * scale.to(ct)).to(zx.dtype)

    @staticmethod
    def backward(ctx, g):
        y, zx, scale, rstd = ctx.saved_tensors
        ct = _compute_dtype(y)
        d = y.shape[-1]
        z = zx[..., :d].to(ct)
        yc, g = y.to(ct), g.to(ct)
        n = yc * F.silu(z) * rstd
        gn = g * scale.to(ct)
        du = rstd * (gn - n * (gn * n).sum(-1, keepdim=True) / d)
        dzx = torch.zeros_like(zx)
        dzx[..., :d] = (du * yc * _silu_grad(z)).to(zx.dtype)
        return ((du * F.silu(z)).to(y.dtype), dzx, (g * n).sum((0, 1)).to(scale.dtype))


def gated_rms_norm_ref(y, zx, scale):
    """`gated_rms_norm`'s arithmetic in plain PyTorch, on any device, with
    the hand-written backward."""
    return _GatedRmsNormRef.apply(y, zx, scale)
