"""The plain reference of the dense and hybrid language models: f32.

Written from the published descriptions, not from the program: RMS
norms, rotary positions (rotate-half), grouped-query softmax attention
over the whole sequence with a causal (and, for the hybrid, sliding
window) mask, SwiGLU MLPs, a tied head; the hybrid adds Mamba-2 heads in
parallel with attention (Hymba, arXiv:2411.13676), each path's output
RMS-normed and the two averaged.  The SSD is the chunked form of the
Mamba-2 paper's minimal listing (arXiv:2405.21060, "ssd_minimal"):
segment sums by masked cumulative sums, no subtraction of long prefix
sums.  Departures from the published models are listed in each
configuration's ``assumed``.

Every tensor is f32 and every matrix product runs without TF32 (the
caller sets ``torch.backends.*.allow_tf32 = False``).  Each layer runs
under `torch.utils.checkpoint`, and the batch is taken in blocks of
rows, so a model of a few billion parameters fits one card beside its
f32 gradients and moments.  `linear` is the one product of activations
and weights; the control swaps it for a lower precision
(`reference.precision`).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .params import Arch

__all__ = ["batch_loss", "rows_per_block"]

Linear = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D] rotated by position (rotate-half pairs i, i + D/2)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(arch: Arch, linear: Linear, h: torch.Tensor, p: dict) -> torch.Tensor:
    b, s, _ = h.shape
    hd, nh, nkv = arch.head_dim, arch.n_heads, arch.n_kv_heads
    q = _rope(linear(h, p["attn.wq"]).view(b, s, nh, hd), arch.rope_theta)
    k = _rope(linear(h, p["attn.wk"]).view(b, s, nkv, hd), arch.rope_theta)
    v = linear(h, p["attn.wv"]).view(b, s, nkv, hd)
    group = nh // nkv  # query head i reads key/value head i // group
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    i = torch.arange(s, device=h.device)
    allowed = i[:, None] >= i[None, :]
    if arch.window is not None:
        allowed &= (i[:, None] - i[None, :]) < arch.window
    probs = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, nh * hd)
    return linear(out, p["attn.wo"])


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: entry (i, j) the sum of x over (j, i] for
    j <= i, -inf above the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1)
    out = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def _ssd(x, dt, a, b_, c_, chunk: int) -> torch.Tensor:
    """Mamba-2's scan h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, in chunks.  x [B, S, H, P], dt [B, S, H], a [H],
    b_ and c_ [B, S, N] (one group) -> y [B, S, H, P]."""
    bsz, s, h, hp = x.shape
    nc = s // chunk
    xd = (x * dt[..., None]).view(bsz, nc, chunk, h, hp)
    da = (dt * a).view(bsz, nc, chunk, h).permute(0, 3, 1, 2)       # [B,H,C,L]
    bq = b_.view(bsz, nc, chunk, -1)
    cq = c_.view(bsz, nc, chunk, -1)
    cum = torch.cumsum(da, dim=-1)
    decay = torch.exp(_segsum(da))                                    # [B,H,C,L,L]
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", cq, bq, decay, xd)
    to_end = torch.exp(cum[..., -1:] - cum)                           # [B,H,C,L]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bq, to_end, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))         # [B,H,C+1,C+1]
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cq, states, torch.exp(cum))
    return (y_diag + y_off).reshape(bsz, s, h, hp)


def _ssm(arch: Arch, linear: Linear, h: torch.Tensor, p: dict) -> torch.Tensor:
    bsz, s, _ = h.shape
    di, n, nh = arch.d_inner, arch.ssm_state, arch.ssm_heads
    z, xbc, dt = torch.split(linear(h, p["ssm.in_proj"]), [di, di + 2 * n, nh], dim=-1)
    width = arch.ssm_conv_width
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (width - 1, 0)),
                    p["ssm.conv_w"].t()[:, None, :], p["ssm.conv_b"], groups=di + 2 * n)
    xbc = F.silu(conv.transpose(1, 2))
    x, b_, c_ = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt + p["ssm.dt_bias"], threshold=1e9)
    a = -torch.exp(p["ssm.A_log"])
    x = x.reshape(bsz, s, nh, arch.ssm_head_dim)
    y = _ssd(x, dt, a, b_, c_, min(arch.ssm_chunk, s)) + p["ssm.D"][:, None] * x
    y = _rms(y.reshape(bsz, s, di) * F.silu(z), p["ssm.gate_norm_scale"], arch.norm_eps)
    return linear(y, p["ssm.out_proj"])


def _layer(arch: Arch, linear: Linear, names: list[str], x: torch.Tensor, *tensors):
    p = dict(zip(names, tensors))
    eps = arch.norm_eps
    attn = _attention(arch, linear, _rms(x, p["attn_norm.scale"], eps), p)
    if arch.hybrid:
        ssm = _ssm(arch, linear, _rms(x, p["ssm_norm.scale"], eps), p)
        x = x + 0.5 * (_rms(attn, p["attn_out_norm.scale"], eps)
                       + _rms(ssm, p["ssm_out_norm.scale"], eps))
    else:
        x = x + attn
    h = _rms(x, p["mlp_norm.scale"], eps)
    mlp = linear(F.silu(linear(h, p["mlp.wi_gate"])) * linear(h, p["mlp.wi_up"]), p["mlp.wo"])
    return x + mlp


def _block_nll(arch: Arch, linear: Linear, params: dict, tokens, labels) -> torch.Tensor:
    """The summed token cross-entropy of a block of rows."""
    x = F.embedding(tokens.long(), params["embed"])
    for i in range(arch.n_layers):
        prefix = f"layers.{i}."
        names = [k[len(prefix):] for k in params if k.startswith(prefix)]
        tensors = [params[prefix + k] for k in names]
        x = checkpoint(_layer, arch, linear, names, x, *tensors, use_reentrant=False)
    x = _rms(x, params["final_norm.scale"], arch.norm_eps)
    logits = linear(x, params["embed"][: arch.vocab_size].t())
    return F.cross_entropy(logits.flatten(0, 1), labels.long().flatten(),
                           ignore_index=-1, reduction="sum")


def rows_per_block(seq: int, tokens_per_block: int = 4096) -> int:
    return max(1, tokens_per_block // seq)


def batch_loss(arch: Arch, linear: Linear, params: dict, tokens: torch.Tensor,
               labels: torch.Tensor, *, backward: bool = True) -> float:
    """The batch's mean token cross-entropy (labels of -1 ignored),
    computed in blocks of rows; with `backward`, each block's share of
    the mean is back-propagated, so ``.grad`` of `params` holds the
    gradient of the whole batch's mean."""
    count = int((labels >= 0).sum())
    rows = rows_per_block(tokens.shape[1])
    total = 0.0
    for r in range(0, tokens.shape[0], rows):
        part = _block_nll(arch, linear, params, tokens[r:r + rows], labels[r:r + rows]) / count
        if backward:
            part.backward()
        total += float(part.detach())
    return total
