"""Shared neural layers: norms, rotary embeddings, MLP variants, embeddings.

Functions on tensors, as in the reference package's `models/layers.py`:
the modules of `transformer.py` hold the parameters and call these.
Weights are stored [in, out] and applied as ``x @ w``, the reference's
layout, so its trees carry across without transposes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "apply_mlp",
    "apply_norm",
    "apply_rope",
    "cross_entropy_loss",
    "dense_init",
    "embed_tokens",
    "lm_logits",
    "mlp_shapes",
    "rope_frequencies",
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


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """`p` holds the weights of `mlp_shapes` as attributes.  GELU is the
    tanh approximation, `jax.nn.gelu`'s default."""
    if act == "swiglu":
        return (F.silu(x @ p.wi_gate) * (x @ p.wi_up)) @ p.wo
    if act == "geglu":
        return (F.gelu(x @ p.wi_gate, approximate="tanh") * (x @ p.wi_up)) @ p.wo
    return F.gelu(x @ p.wi + p.bi, approximate="tanh") @ p.wo + p.bo


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return F.embedding(tokens, emb.to(compute_dtype))


def lm_logits(
    x: torch.Tensor, emb: torch.Tensor, head: torch.Tensor | None, vocab_size: int
) -> torch.Tensor:
    """Final logits in f32; padded vocab columns are masked to -1e9."""
    w = emb.t() if head is None else head
    logits = (x @ w.to(x.dtype)).float()
    vpad = logits.shape[-1]
    if vpad > vocab_size:
        col = torch.arange(vpad, device=logits.device)
        logits = torch.where(col < vocab_size, logits, -1e9)
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; ignores label == -1.

    The gold logit is a gather: the reference's equality-mask contraction
    adds exact zeros to it, so both give the same value and gradient.
    """
    mask = labels >= 0
    safe = labels.clamp_min(0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None].long()).squeeze(-1)
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)
