"""Shared neural layers: norms, rotary embeddings, MLP variants, embeddings.

Functions on tensors, as in the reference package's `models/layers.py`:
the modules of `transformer.py` hold the parameters and call these.
Weights are stored [in, out] and applied as ``x @ w``, the reference's
layout, so its trees carry across without transposes.  The logical
sharding axes of every parameter are declared beside it in the `*_axes`
helpers (one axis name or None per dimension), read by
`repro_torch.distributed.sharding`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..telemetry import regions

__all__ = [
    "apply_mlp",
    "apply_norm",
    "apply_rope",
    "cross_entropy_loss",
    "dense_init",
    "embed_tokens",
    "gathered_columns",
    "lm_logits",
    "mlp_axes",
    "mlp_shapes",
    "norm_axes",
    "rope_frequencies",
    "vocab_parallel",
    "whole_columns",
]

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor | None,
    kind: str,
    eps: float = 1e-6,
) -> torch.Tensor:
    """RMS norm or LayerNorm, computed in f32 and cast back to x's dtype."""
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * scale.float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def norm_axes(kind: str) -> dict:
    p = {"scale": (None,)}
    if kind == "ln":
        p["bias"] = (None,)
    return p


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(
    generator: torch.Generator,
    shape: tuple[int, ...],
    dtype: torch.dtype,
    device,
    scale: float | None = None,
) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) (or `scale`), drawn in f32 on the
    generator's device (the CPU), so a seed gives the same weights on
    every device."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    return w.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] or [S]. Rotate-half convention,
    f32 angles."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs             # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ---------------------------------------------------------------------------


def mlp_shapes(d_model: int, d_ff: int, act: str) -> dict[str, tuple[int, ...]]:
    """Parameter name -> shape, in the reference's init order."""
    if act in ("swiglu", "geglu"):
        return {
            "wi_gate": (d_model, d_ff),
            "wi_up": (d_model, d_ff),
            "wo": (d_ff, d_model),
        }
    return {
        "wi": (d_model, d_ff),
        "bi": (d_ff,),
        "wo": (d_ff, d_model),
        "bo": (d_model,),
    }


def mlp_axes(act: str) -> dict:
    """Parameter name -> logical axes, the names of `mlp_shapes`."""
    if act in ("swiglu", "geglu"):
        return {
            "wi_gate": ("embed", "mlp"),
            "wi_up": ("embed", "mlp"),
            "wo": ("mlp", "embed"),
        }
    return {
        "wi": ("embed", "mlp"),
        "bi": ("mlp",),
        "wo": ("mlp", "embed"),
        "bo": ("embed",),
    }


def apply_mlp(p, x: torch.Tensor, act: str, tp=None) -> torch.Tensor:
    """`p` holds the weights of `mlp_shapes` as attributes.  GELU is the
    tanh approximation, `jax.nn.gelu`'s default.

    With a `TensorParallel` context `tp` whose rank holds a shard of the
    hidden dim, the input products are column products on that shard
    (``bi`` with them), ``wo`` a row product whose partial sums are
    all-reduced, and ``bo`` is added once, after the all-reduce."""
    if tp is None or tp.dim(p.wo) is None:
        if act == "swiglu":
            return (F.silu(x @ p.wi_gate) * (x @ p.wi_up)) @ p.wo
        if act == "geglu":
            return (F.gelu(x @ p.wi_gate, approximate="tanh") * (x @ p.wi_up)) @ p.wo
        return F.gelu(x @ p.wi + p.bi, approximate="tanh") @ p.wo + p.bo
    x = tp.copy(x)
    if act == "swiglu":
        return tp.reduce((F.silu(x @ p.wi_gate) * (x @ p.wi_up)) @ p.wo)
    if act == "geglu":
        return tp.reduce((F.gelu(x @ p.wi_gate, approximate="tanh") * (x @ p.wi_up)) @ p.wo)
    return tp.reduce(F.gelu(x @ p.wi + p.bi, approximate="tanh") @ p.wo) + p.bo


def whole_columns(tp, w: torch.Tensor, b: torch.Tensor | None, part: slice):
    """Columns `part` of a weight (and its bias) every rank holds whole,
    through `copy`: the ranks' gradients of their slices are all-reduced."""
    return tp.copy(w)[:, part], None if b is None else tp.copy(b)[part]


def gathered_columns(tp, x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, xc: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """``x @ w (+ b)`` whole on every rank of the model axis (`tp`), each
    rank computing its part of the columns: on its shard of a split `w`;
    of a whole `w`, on its even share of the largest prefix of the
    columns the axis divides, the rest computed whole on every rank.
    The shares are column products on ``xc = tp.copy(x)`` (passed where
    the caller has it) and, of a whole `w` and `b`, on their copies, so
    the ranks' gradients of their columns are all-reduced; the rest's
    gradient is the same on every rank."""
    def product(x_, w_, b_):
        y = x_ @ w_
        return y if b_ is None else y + b_

    if tp.size == 1:
        return product(x, w, b)
    xc = tp.copy(x) if xc is None else xc
    if tp.dim(w) is not None:
        return tp.gather(product(xc, w, b), -1)
    n = w.shape[-1] // tp.size
    part, rest = slice(tp.start(n), tp.start(n) + n), slice(n * tp.size, None)
    parts = []
    if n:
        parts.append(tp.gather(product(xc, *whole_columns(tp, w, b, part)), -1))
    if n * tp.size < w.shape[-1]:
        parts.append(product(x, w[:, rest], None if b is None else b[rest]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------


def vocab_parallel(emb: torch.Tensor, head: torch.Tensor | None, tp):
    """`tp` when this rank holds a shard of the vocab (of the head, or of
    the embedding that doubles as it), else None."""
    return tp if tp is not None and tp.dim(emb if head is None else head) is not None else None


def _local_ids(ids: torch.Tensor, rows: int, tp):
    """(ids as rows of this rank's `rows`-row vocab shard, clamped into
    it; whether each id falls in the shard)."""
    local = ids.long() - tp.start(rows)
    inside = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), inside


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor, compute_dtype,
                 tp=None) -> torch.Tensor:
    """The tokens' rows of `emb`.  With `tp` and `emb` split over the
    vocab, each rank looks up the ids of its rows, zeros the others, and
    the ranks' rows are all-reduced (a sum of one row and exact zeros).
    A timed region (`telemetry.regions`), entered on the weight as the
    lookup reads it: `tp` knows `emb` itself, not the marker's view."""
    if tp is None or tp.dim(emb) is None:
        return regions.exit("embed", F.embedding(
            tokens, regions.enter("embed", emb.to(compute_dtype))))
    local, inside = _local_ids(tokens, emb.shape[0], tp)
    x = F.embedding(local, regions.enter("embed", emb.to(compute_dtype)))
    return regions.exit("embed", tp.reduce(torch.where(inside[..., None], x, 0)))


def lm_logits(
    x: torch.Tensor, emb: torch.Tensor, head: torch.Tensor | None, vocab_size: int,
    tp=None,
) -> torch.Tensor:
    """Final logits in f32; padded vocab columns are masked to -1e9.
    With `tp` and the vocab split, the logits of this rank's vocab
    columns (a column product), the padding masked by global column."""
    w = emb.t() if head is None else head
    tp = vocab_parallel(emb, head, tp)
    if tp is not None:
        x = tp.copy(x)
    logits = (x @ w.to(x.dtype)).float()
    cols = logits.shape[-1]
    first = 0 if tp is None else tp.start(cols)
    if first + cols > vocab_size:
        col = first + torch.arange(cols, device=logits.device)
        logits = torch.where(col < vocab_size, logits, -1e9)
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       tp=None) -> torch.Tensor:
    """Mean token cross-entropy; ignores label == -1.

    The gold logit is a gather: the reference's equality-mask contraction
    adds exact zeros to it, so both give the same value and gradient.
    With `tp`, `logits` are this rank's vocab columns (`lm_logits`): the
    max, the sum of exponentials and the gold logit are all-reduced over
    the model axis, so every rank gets the whole loss.
    """
    mask = labels >= 0
    safe = labels.clamp_min(0)
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, safe[..., None].long()).squeeze(-1)
    else:
        top = tp.max(logits.amax(dim=-1))
        logz = top + torch.log(tp.reduce(torch.exp(logits - top[..., None]).sum(-1)))
        local, inside = _local_ids(safe, logits.shape[-1], tp)
        gold = logits.gather(-1, local[..., None]).squeeze(-1)
        gold = tp.reduce(torch.where(inside, gold, 0.0))
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)
