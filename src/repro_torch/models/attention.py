"""Attention: chunked online-softmax causal attention (optionally a
sliding window), in the reference's chunk order.

GQA is computed *grouped* (no repeat of K/V): queries are reshaped to
[B, S, KV, G, D] and contracted against the un-expanded KV.

Prefill runs a double-chunked online softmax: for each Q chunk, a walk
over KV chunks carrying (max, denominator, accumulator), so peak scores
memory is q_chunk x kv_chunk instead of S^2.  Eager PyTorch has no scan,
so the reference's scan and its unrolled form are one Python loop here.
With ``triangular=True`` the walk takes only the KV chunks a Q chunk can
see.  `scaled_dot_product_attention` does not stand in for this: the
port follows the reference's arithmetic, chunk by chunk.

The single-token decode functions belong to the serving slice.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["NEG", "chunked_causal_attention"]

NEG = -1e30


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _chunk_attn_block(
    qg: torch.Tensor,      # [B, Sq, KV, G, D]
    k: torch.Tensor,       # [B, Skv, KV, D]
    v: torch.Tensor,       # [B, Skv, KV, D]
    mask: torch.Tensor,    # [Sq, Skv] bool (True = attend)
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    scale: float,
    cast_f32: bool = True,
):
    """One online-softmax accumulation step. state = (m, l, acc).

    Scores are f32 either way: a product of two bf16 values is exact in
    f32, so the reference's bf16 operands with f32 accumulation
    (cast_f32=False) give the f32 product; cast_f32=False rounds the
    probabilities to V's dtype before the PV product, as the reference
    does.
    """
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    s = torch.where(mask, s, NEG)
    m_new = s.amax(dim=-1)                                   # [B,KV,G,Sq]
    p = torch.exp(s - m_new[..., None])
    l_new = p.sum(dim=-1)
    if not cast_f32:
        p = p.to(v.dtype).float()
    pv = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    m, l, acc = state
    m2 = torch.maximum(m, m_new)
    c_old = torch.exp(m - m2)
    c_new = torch.exp(m_new - m2)
    return m2, l * c_old + l_new * c_new, acc * c_old[..., None] + pv * c_new[..., None]


def _finish(m, l, acc, b, sq, h, d, dtype):
    out = acc / l[..., None].clamp_min(1e-30)                # [B,KV,G,Sq,D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(dtype)


def chunked_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    window: int | None = None,
    triangular: bool = False,
    cast_f32: bool = True,
    remat_qblock: bool = True,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, O(q_chunk*kv_chunk) memory.

    q: [B, S, H, D]; k, v: [B, S, KV, D].  S must divide by the chunk sizes
    (configs guarantee this; tests use small aligned chunks).
    ``remat_qblock`` recomputes each Q block's online softmax in the
    backward pass (`torch.utils.checkpoint`) instead of keeping its
    per-chunk probabilities.
    """
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    scale = 1.0 / (d**0.5)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    nq, nkv = s // q_chunk, s // kv_chunk
    qs = _group_q(q, n_kv).reshape(b, nq, q_chunk, n_kv, g, d)
    ks = k.reshape(b, nkv, kv_chunk, n_kv, d)
    vs = v.reshape(b, nkv, kv_chunk, n_kv, d)

    qpos_in = torch.arange(q_chunk, device=q.device)
    kpos_in = torch.arange(kv_chunk, device=q.device)

    def mask_for(iq, jk):
        qpos = iq * q_chunk + qpos_in                          # [q_chunk]
        kpos = jk * kv_chunk + kpos_in                         # [kv_chunk]
        m = qpos[:, None] >= kpos[None, :]
        if window is not None:
            m &= qpos[:, None] - kpos[None, :] < window
        return m

    def q_block(iq, qb):
        # qb: [B, q_chunk, KV, G, D]
        if triangular:
            # only chunks overlapping [lo, hi] are touched
            hi = (iq + 1) * q_chunk  # exclusive
            lo = 0 if window is None else max(0, iq * q_chunk - window + 1)
            chunks = range(lo // kv_chunk, (hi + kv_chunk - 1) // kv_chunk)
        else:
            chunks = range(nkv)
        state = (
            torch.full((b, n_kv, g, q_chunk), NEG, dtype=torch.float32, device=q.device),
            torch.zeros((b, n_kv, g, q_chunk), dtype=torch.float32, device=q.device),
            torch.zeros((b, n_kv, g, q_chunk, d), dtype=torch.float32, device=q.device),
        )
        for jk in chunks:
            state = _chunk_attn_block(
                qb, ks[:, jk], vs[:, jk], mask_for(iq, jk), state, scale, cast_f32
            )
        return _finish(*state, b, q_chunk, h, d, q.dtype)

    outs = []
    for iq in range(nq):
        if remat_qblock:
            outs.append(checkpoint(
                q_block, iq, qs[:, iq], use_reentrant=False, preserve_rng_state=False
            ))
        else:
            outs.append(q_block(iq, qs[:, iq]))
    return torch.cat(outs, dim=1)
