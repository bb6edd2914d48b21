"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060).

Chunked SSD: the sequence is split into chunks of Q tokens; within a
chunk the output is the quadratic ("attention-like") masked form; the
[B, H, P, N] state entering each chunk is one product of the chunks'
states with the decays between them, where the reference scans over
the chunks.

Decode is the recurrent form: h <- h * exp(dt*A) + dt * (B outer x); one
token costs O(H*P*N) and the cache is (conv tail, state), both f32,
independent of context length.

`A_log`, `D` and `dt_bias` are f32 whatever the model's parameter dtype,
as in the reference.  `jax.nn.softplus` is ``logaddexp(x, 0)`` at every x;
`torch.nn.functional.softplus` returns x itself past its threshold, so
the port takes `torch.logaddexp`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake

from ..kernels.ssd import ssd_scan
from ..telemetry import regions
from .layers import dense_init, gathered_columns

__all__ = [
    "SSM",
    "apply_ssm",
    "channel_heads",
    "decode_ssm",
    "init_ssm_cache",
    "split_ssm",
    "ssm_axes",
]


def _dims(cfg):
    d_inner = cfg.ssm_d_inner
    n_heads = cfg.ssm_n_heads
    p = cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n  # x, B, C pass through the conv (ngroups=1)
    return d_inner, n_heads, p, n, conv_dim


class SSM(nn.Module):
    """The mixer's parameters, named as the reference's `init_ssm` tree."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d_inner, h, p, n, conv_dim = _dims(cfg)
        d = cfg.d_model
        in_dim = 2 * d_inner + 2 * n + h  # z, x, B, C, dt
        f32 = torch.float32
        param = nn.Parameter
        self.in_proj = param(dense_init(generator, (d, in_dim), dtype, device))
        self.conv_w = param(dense_init(
            generator, (cfg.ssm_conv_width, conv_dim), dtype, device, scale=0.5))
        self.conv_b = param(torch.zeros(conv_dim, dtype=dtype, device=device))
        self.A_log = param(torch.zeros(h, dtype=f32, device=device))
        self.D = param(torch.ones(h, dtype=f32, device=device))
        self.dt_bias = param(torch.zeros(h, dtype=f32, device=device))
        self.out_proj = param(dense_init(generator, (d_inner, d), dtype, device))
        self.gate_norm_scale = param(torch.ones(d_inner, dtype=dtype, device=device))


def ssm_axes() -> dict:
    """Logical axes of `SSM`'s parameters."""
    return {
        "in_proj": ("embed", "mlp"),
        "conv_w": (None, "mlp"),
        "conv_b": ("mlp",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "out_proj": ("mlp", "embed"),
        "gate_norm_scale": ("mlp",),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(cfg, zxbcdt):
    d_inner, h, p, n, _ = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)


def _gated_norm(p, y, z, tp=None):
    """The gated RMS norm over d_inner; with `tp` and the scale split,
    this rank's slice of it (the norm itself is over the whole dim)."""
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    if tp is not None and tp.dim(p.gate_norm_scale) is not None:
        yf = tp.split(yf, -1)
    return yf * p.gate_norm_scale.float()


def _causal_conv(x, w, b):
    """x: [B, S, C]; w: [W, C] depthwise causal conv."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:x.shape[1], :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: entry (i, j) the sum of x over (j, i] for
    j <= i, by a masked cumulative sum (no difference of long prefix
    sums), and -inf above the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device), -1)
    out = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def _ssd(xh, dt, a, d_skip, b_, c_, q):
    """The chunked SSD over the heads given: xh [B, S, H, P] (the conv's
    x), dt [B, S, H] (after the softplus), a and d_skip [H], b_ and c_
    [B, S, N] -> y [B, S, H, P] f32, the D term added.  Each head's
    channels depend on that head's dt, a and D and on the shared B and C
    only, so a slice of the heads gives that slice of y.

    CUDA tensors go to the kernels (`kernels.ssd.ssd_scan`: the same
    scan in f32 with each chunk's decays and scores kept on the chip; a
    CUDA input they do not take raises); CPU tensors, and the dry run's
    fake tensors, take the plain version (`_ssd_plain`).  The region
    ``ssm_scan`` (nested in ``ssm``) spans either."""
    xh = regions.enter("ssm_scan", xh)
    if xh.device.type == "cuda" and not is_fake(xh):
        y = ssd_scan(xh, dt, a, d_skip, b_, c_, q)
    else:
        y = _ssd_plain(xh, dt, a, d_skip, b_, c_, q)
    return regions.exit("ssm_scan", y)


def _ssd_plain(xh, dt, a, d_skip, b_, c_, q):
    """`_ssd` in plain PyTorch on any device: what CPU tensors take, and
    what the card's kernels are held against.

    Within a chunk, the decay from token j to token i is exp of the
    difference of their cumulative sums, masked to -inf above the
    diagonal *before* the exp: above it the difference is positive and
    overflows, and an inf there would turn the backward of a later mask
    into NaN.  Across chunks, each chunk's entering state is one product
    of the chunks' states with the decays between them (`_segsum` of the
    chunks' totals), not a loop."""
    b, s, h, hp = xh.shape
    n = b_.shape[-1]
    nc = s // q
    # chunked views, head-major: [B, NC, H, Q(, P)]
    xq = (xh * dt[..., None]).reshape(b, nc, q, h, hp).transpose(2, 3)  # dt-weighted input
    bq = b_.reshape(b, nc, q, n)
    cq = c_.reshape(b, nc, q, n)
    da = dt.reshape(b, nc, q, h) * a[None, None, None, :]
    cum = torch.cumsum(da, dim=2).transpose(2, 3)                   # [B,NC,H,Q] within-chunk

    # ---- intra-chunk (quadratic within chunk) -----------------------------
    # L[i,j] = exp(cum[i] - cum[j]) for j <= i else 0
    keep = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~keep, float("-inf"))
    scores = torch.einsum("bcin,bcjn->bcij", cq, bq)                # [B,NC,Q,Q]
    y = (scores[:, :, None] * torch.exp(seg)) @ xq                  # [B,NC,H,Q,P]

    # ---- chunk states, then the state entering each chunk ------------------
    to_end = torch.exp(cum[..., -1:] - cum)                         # [B,NC,H,Q]
    states = torch.einsum("bcjn,bchj,bchjp->bchpn", bq, to_end, xq)  # [B,NC,H,P,N]
    totals = F.pad(cum[..., -1].transpose(1, 2), (1, 0))            # [B,H,NC+1]
    across = torch.exp(_segsum(totals))[..., :-1, 1:]               # [B,H,NC,NC]
    h_in = torch.einsum("bhzc,bchpn->bzhpn", across, states)        # [B,NC,H,P,N]
    y = y + torch.exp(cum)[..., None] * (cq[:, :, None] @ h_in.transpose(-1, -2))

    y = y.transpose(2, 3).reshape(b, s, h, hp)
    return y + d_skip[None, None, :, None] * xh.float()


def channel_heads(lo: int, hi: int, head_dim: int) -> tuple[int, int]:
    """The heads [h0, h1) that channels [lo, hi) of d_inner touch."""
    return lo // head_dim, -(-hi // head_dim)


def _ssd_channels(p, xs, b_, c_, dt, zs, lo: int, hi: int, cfg, take=lambda w: w):
    """Channels [lo, hi) of the SSD, gated, from those channels of the
    conv's x and of z (`xs`, `zs` [B, S, hi - lo]), the shared B and C,
    and the dt of the heads they touch (`dt` [B, S, h1 - h0], before the
    softplus): the scan on those heads at whole head dim, their other
    channels zero (a channel's output reads its own input channel only),
    then the channels times silu(z), f32 [B, S, hi - lo], before the
    norm.  `take` routes a whole parameter (`A_log`, `D`, `dt_bias`)
    before its heads are read (`tp.copy` on a rank of the model axis)."""
    b, s, _ = xs.shape
    hp = cfg.ssm_head_dim
    h0, h1 = channel_heads(lo, hi, hp)
    a = -torch.exp(take(p.A_log)[h0:h1])
    dt = _softplus(dt.float() + take(p.dt_bias)[h0:h1])
    xh = F.pad(xs, (lo - h0 * hp, h1 * hp - hi)).reshape(b, s, h1 - h0, hp)
    y = _ssd(xh, dt, a, take(p.D)[h0:h1], b_, c_, min(cfg.ssm_chunk, s))
    y = y.reshape(b, s, -1)[..., lo - h0 * hp:hi - h0 * hp]
    return y * F.silu(zs.float())


def _norm_channels(yf, sumsq, d_inner: int, scale):
    """A slice of the gated RMS norm: `yf` [B, S, C] scaled by the sum of
    squares over the whole d_inner (`sumsq` [B, S, 1]), times its slice
    of the norm's `scale`."""
    return yf * torch.rsqrt(sumsq / d_inner + 1e-6) * scale.float()


def _projections(p, x, cfg, tp):
    """(z, the conv's output [x, B, C] after the silu, f32, dt) of x:
    ``in_proj`` and the causal conv, whole (on every rank of `tp`:
    ``in_proj`` as `layers.gathered_columns`, the conv on this rank's
    channels where its weights are split, gathered)."""
    zxbcdt = x @ p.in_proj if tp is None else gathered_columns(tp, x, p.in_proj)
    z, xc, b_, c_, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xc, b_, c_], dim=-1)
    if tp is not None and tp.dim(p.conv_w) is not None:
        conv_out = tp.gather(F.silu(_causal_conv(
            tp.split(conv_in, -1), p.conv_w, p.conv_b).float()), -1)
    else:
        conv_out = F.silu(_causal_conv(conv_in, p.conv_w, p.conv_b).float())
    return z, conv_out, dt


def _split_projections(p, x, cfg, tp, lo: int, hi: int):
    """(z and the conv's x on channels [lo, hi), the conv's B and C
    whole, the dt of the heads those channels touch): what this rank of
    the split scan reads (`apply_ssm`), computed on it and nothing more.
    Its columns of ``in_proj`` (z, x, dt) are column products on copies
    of x and of the whole weight (gathered first where it is split); the
    B and C columns are split over the ranks and gathered
    (`layers.gathered_columns`, its remainder whole), then copied, as
    every rank reads them whole for its own channels.  The depthwise
    conv runs on the rank's x channels and on B and C, its weights whole
    (gathered where split) through `copy`, so each gradient is the
    ranks' shares summed."""
    d_inner, _, hp, n, _ = _dims(cfg)
    h0, h1 = channel_heads(lo, hi, hp)
    xc = tp.copy(x)
    w = p.in_proj if tp.dim(p.in_proj) is None else tp.gather(p.in_proj, -1)
    wc = tp.copy(w)
    dt0 = 2 * d_inner + 2 * n
    z = xc @ wc[:, lo:hi]
    xs = xc @ wc[:, d_inner + lo:d_inner + hi]
    dt = xc @ wc[:, dt0 + h0:dt0 + h1]
    bc = tp.copy(gathered_columns(tp, x, w[:, 2 * d_inner:dt0], xc=xc))
    cw, cb = (tp.copy(t if tp.dim(t) is None else tp.gather(t, -1))
              for t in (p.conv_w, p.conv_b))
    xs = F.silu(_causal_conv(xs, cw[:, lo:hi], cb[lo:hi]).float())
    b_, c_ = torch.split(F.silu(_causal_conv(bc, cw[:, d_inner:], cb[d_inner:]).float()),
                         [n, n], dim=-1)
    return z, xs, b_, c_, dt


def _splits_scan(p: SSM, cfg, tp) -> bool:
    """Whether `apply_ssm` splits the scan over `tp`'s model axis: more
    than one rank, ``out_proj`` split over it, d_inner divided by it."""
    return (tp is not None and tp.size > 1 and tp.dim(p.out_proj) is not None
            and cfg.ssm_d_inner % tp.size == 0)


def apply_ssm(p: SSM, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """Full-sequence SSD. x: [B, S, D] -> [B, S, D].

    Where `_splits_scan`, the scan runs on this rank's slice of d_inner,
    the channels of its ``out_proj`` rows, on the heads they touch, from
    those channels of z and x, B and C whole and those heads' dt
    (`_split_projections`: no whole projection is gathered); the gated
    norm's sum of squares is all-reduced, and ``A_log``, ``D``,
    ``dt_bias`` go through `copy`, so their gradients are the ranks'
    shares summed.  Otherwise, with `tp`, ``in_proj`` is a column product
    gathered whole before the z/x/B/C/dt split (whose boundaries need not
    fall on the shard's; `layers.gathered_columns`), the depthwise conv
    runs on this rank's channels, gathered, the scan runs whole on every
    rank, the gated norm is cut to this rank's ``out_proj`` rows where
    those are split, and ``out_proj`` is a row product, all-reduced.
    """
    b, s, d = x.shape
    d_inner, h, hp, n, conv_dim = _dims(cfg)
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, f"seq {s} must divide ssm_chunk {q}"
    if _splits_scan(p, cfg, tp):
        lo = tp.start(d_inner // tp.size)
        hi = lo + d_inner // tp.size
        z, xs, b_, c_, dt = _split_projections(p, x, cfg, tp, lo, hi)
        yf = _ssd_channels(p, xs, b_, c_, dt, z, lo, hi, cfg, take=tp.copy)
        sumsq = tp.copy(tp.reduce((yf * yf).sum(-1, keepdim=True)))
        scale = p.gate_norm_scale
        if tp.dim(scale) is None:
            scale = tp.copy(scale)[lo:hi]
        y = _norm_channels(yf, sumsq, d_inner, scale)
        return tp.reduce(y.to(x.dtype) @ p.out_proj)
    z, conv_out, dt = _projections(p, x, cfg, tp)
    xc, b_, c_ = torch.split(conv_out, [d_inner, n, n], dim=-1)
    a = -torch.exp(p.A_log)                                         # [H]
    dt = _softplus(dt.float() + p.dt_bias)                          # [B,S,H]
    y = _ssd(xc.reshape(b, s, h, hp), dt, a, p.D, b_, c_, q)
    y = _gated_norm(p, y.reshape(b, s, d_inner), z, tp)
    if tp is not None and tp.dim(p.out_proj) is not None:
        return tp.reduce(y.to(x.dtype) @ p.out_proj)
    return y.to(x.dtype) @ p.out_proj


def split_ssm(p: SSM, x: torch.Tensor, cfg, parts: int) -> torch.Tensor:
    """The split scan's plain version, in one process: `apply_ssm`'s
    output with the scan and the gated norm computed as `parts` ranks of
    the model axis would (each its slice of d_inner, the sums of squares
    summed over the slices), the slices concatenated before ``out_proj``.
    """
    d_inner, _, _, n, _ = _dims(cfg)
    z, conv_out, dt = _projections(p, x, cfg, None)
    xc, b_, c_ = torch.split(conv_out, [d_inner, n, n], dim=-1)
    width, hp = d_inner // parts, cfg.ssm_head_dim
    yfs = []
    for lo in range(0, d_inner, width):
        h0, h1 = channel_heads(lo, lo + width, hp)
        yfs.append(_ssd_channels(p, xc[..., lo:lo + width], b_, c_, dt[..., h0:h1],
                                 z[..., lo:lo + width], lo, lo + width, cfg))
    sumsq = sum((yf * yf).sum(-1, keepdim=True) for yf in yfs)
    scale = p.gate_norm_scale
    y = torch.cat([_norm_channels(yf, sumsq, d_inner, scale[r * width:(r + 1) * width])
                   for r, yf in enumerate(yfs)], dim=-1)
    return y.to(x.dtype) @ p.out_proj


# ---------------------------------------------------------------------------
# Decode (recurrent form)
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg, batch: int, device) -> dict:
    d_inner, h, p, n, conv_dim = _dims(cfg)
    return {
        "state": torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=torch.float32, device=device),
    }


def decode_ssm(p: SSM, cache: dict, x: torch.Tensor, cfg, tp=None):
    """One-token step. x: [B, 1, D] -> (y [B, 1, D], new cache).

    With `tp` (a serve step's context; the caches are this rank's batch
    rows, whole over the model axis): ``in_proj`` a column product
    gathered whole (`layers.gathered_columns`), the depthwise conv on
    this rank's channels where its weights are split, gathered, the
    recurrence whole on every rank, and ``out_proj`` a row product on
    this rank's slice of the gated norm, all-reduced.  The state and the
    conv tail hold every channel on every rank of the model axis, so
    each rank's step reads them whole, unlike the split scan's."""
    b = x.shape[0]
    d_inner, h, hp, n, conv_dim = _dims(cfg)
    split = lambda w: tp is not None and tp.dim(w) is not None
    if tp is not None:
        zxbcdt = gathered_columns(tp, x[:, 0, :], p.in_proj)
    else:
        zxbcdt = x[:, 0, :] @ p.in_proj
    z, xc, b_, c_, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xc, b_, c_], dim=-1)                       # [B, convdim]
    window = torch.cat([cache["conv"], conv_in[:, None, :].float()], dim=1)  # [B,W,convdim]
    w = p.conv_w.float()
    if split(p.conv_w):
        conv_out = tp.gather(F.silu((tp.split(window, -1) * w[None]).sum(dim=1) + p.conv_b), -1)
    else:
        conv_out = F.silu((window * w[None]).sum(dim=1) + p.conv_b)
    xc, b_, c_ = torch.split(conv_out, [d_inner, n, n], dim=-1)

    a = -torch.exp(p.A_log)
    dt_ = _softplus(dt.float() + p.dt_bias)                         # [B,H]
    xh = xc.reshape(b, h, hp)
    decay = torch.exp(dt_ * a[None, :])                             # [B,H]
    add = torch.einsum("bh,bn,bhp->bhpn", dt_, b_, xh)
    state = cache["state"] * decay[:, :, None, None] + add
    y = torch.einsum("bn,bhpn->bhp", c_, state)
    y = y + p.D[None, :, None] * xh
    y = _gated_norm(p, y.reshape(b, d_inner), z, tp)
    if split(p.out_proj):
        out = tp.reduce(y.to(x.dtype) @ p.out_proj)
    else:
        out = y.to(x.dtype) @ p.out_proj
    return out[:, None, :], {"state": state, "conv": window[:, 1:, :]}
