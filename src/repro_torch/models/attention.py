"""Attention: chunked online-softmax causal attention (optionally a
sliding window), in the reference's chunk order, and the un-chunked
bidirectional attention of the encoder and the cross-attention.

GQA is computed *grouped* (no repeat of K/V): queries are reshaped to
[B, S, KV, G, D] and contracted against the un-expanded KV.

Prefill runs a double-chunked online softmax: for each Q chunk, a walk
over KV chunks carrying (max, denominator, accumulator), so peak scores
memory is q_chunk x kv_chunk instead of S^2.  Eager PyTorch has no scan,
so the reference's scan and its unrolled form are one Python loop here.
With ``triangular=True`` the walk takes only the KV chunks a Q chunk can
see; the other chunks add exactly 0 to its sum and accumulator (their
``exp(NEG - m)`` is 0), so both walks give the same values.

On the card a hand-written kernel (`kernels.attention.causal_attention`)
takes the same walk tile by tile, at f32 precision with another order of
f32 sums: scores, probabilities and their gradients stay on the chip, key
tiles the mask hides are skipped, and the backward recomputes the
probabilities from the saved log-sum-exp.  A CUDA input the kernel does
not take raises.  CPU tensors, and the dry run's fake tensors (no data;
the dry run counts the plain walk's operations), keep the plain walk.

Prefill split over query blocks (a rank of the model axis that holds
whole heads and too few (batch, kv head) groups to share them): each
rank takes its rows of the queries against whole keys and values
(`query_split`; `query_split_attention` takes every rank's in one
process).  A causal rank takes ``q_chunk``-row blocks in zigzag
(`zigzag_blocks`) and hands their global indices to
`chunked_causal_attention` (``q_blocks``), so each block's mask and
triangular walk are the whole walk's.

Decode attends one token against a KV cache in either layout: ``bskd``
([B, S_cache, KV, D]) or head-major ``bksd`` ([B, KV, S_cache, D]), whose
(B, KV) leading dims are the einsum's batch dims.  The cache writes go in
place; the reference donates its caches, so both give the same values.

Sequence-parallel decode (`DECODE_PLAN`: the cache sequence split over
the model axis) runs the same softmax on chunks of the cache
(`chunked_decode_attention` takes them in one process, `decode_attention`
and `decode_attention_bksd` one rank's chunk with its ``offset`` and
`combine`, the ranks' collectives): each chunk's scores, the max
combined over the chunks, then the sum of exponentials, then each
chunk's normalised probabilities (rounded to the cache dtype where
``cast_f32=False``, as the one-chunk form) times its values, summed.
These two passes round where the one-chunk form rounds; a one-pass
(max, sum, accumulator) combine would round the unnormalised values.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import causal_attention
from ..telemetry import regions

__all__ = [
    "NEG",
    "chunked_causal_attention",
    "chunked_causal_attention_plain",
    "chunked_decode_attention",
    "decode_attention",
    "decode_attention_bksd",
    "full_cross_attention",
    "kv_chunks",
    "query_split",
    "query_split_attention",
    "update_kv_cache",
    "update_kv_cache_bksd",
    "zigzag_blocks",
]

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
    q_blocks: Sequence[int] | None = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, O(q_chunk*kv_chunk) memory.

    q: [B, Sq, H, D]; k, v: [B, S, KV, D].  S must divide by the chunk sizes
    (configs guarantee this; tests use small aligned chunks).
    ``remat_qblock`` recomputes each Q block's online softmax in the
    backward pass (`torch.utils.checkpoint`) instead of keeping its
    per-chunk probabilities.  ``q_blocks``: the global indices of the
    ``q_chunk``-row blocks of the sequence that q holds, in order (None:
    all of them, Sq = S); each block's mask and triangular walk follow
    its global positions, so it is computed as the whole walk computes it.

    CUDA tensors go to the kernel (`kernels.attention.causal_attention`),
    which keeps nothing of P whatever ``remat_qblock`` says and walks the
    key tiles a query tile sees whatever ``triangular`` says; it raises for
    ``cast_f32=False`` on bf16 tensors, which no configuration runs there.
    """
    if q.device.type != "cuda" or is_fake(q):
        return chunked_causal_attention_plain(
            q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, window=window, triangular=triangular,
            cast_f32=cast_f32, remat_qblock=remat_qblock, q_blocks=q_blocks)
    return causal_attention(q, k, v, window=window, cast_f32=cast_f32, q_blocks=q_blocks,
                            q_chunk=min(q_chunk, k.shape[1]))


def chunked_causal_attention_plain(
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
    q_blocks: Sequence[int] | None = None,
) -> torch.Tensor:
    """`chunked_causal_attention`'s plain walk on any device: what CPU
    tensors take, and what the card's kernel is held against."""
    b, sq, h, d = q.shape
    s = k.shape[1]
    n_kv = k.shape[2]
    g = h // n_kv
    scale = 1.0 / (d**0.5)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    if q_blocks is None:
        q_blocks = range(s // q_chunk)
    nq, nkv = len(q_blocks), s // kv_chunk
    assert nq * q_chunk == sq, (sq, q_chunk, list(q_blocks))
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
        # qb: [B, q_chunk, KV, G, D]; its remat's re-run inside the
        # attention's backward is timed as the attention's recompute
        with regions.recomputing("attention"):
            return _q_block(iq, qb)

    def _q_block(iq, qb):
        state = (
            torch.full((b, n_kv, g, q_chunk), NEG, dtype=torch.float32, device=q.device),
            torch.zeros((b, n_kv, g, q_chunk), dtype=torch.float32, device=q.device),
            torch.zeros((b, n_kv, g, q_chunk, d), dtype=torch.float32, device=q.device),
        )
        for jk in kv_chunks(iq, q_chunk, kv_chunk, nkv, window, triangular):
            state = _chunk_attn_block(
                qb, ks[:, jk], vs[:, jk], mask_for(iq, jk), state, scale, cast_f32
            )
        return _finish(*state, b, q_chunk, h, d, q.dtype)

    outs = []
    for i, iq in enumerate(q_blocks):
        if remat_qblock:
            outs.append(checkpoint(
                q_block, iq, qs[:, i], use_reentrant=False, preserve_rng_state=False
            ))
        else:
            outs.append(q_block(iq, qs[:, i]))
    return torch.cat(outs, dim=1)


def kv_chunks(iq: int, q_chunk: int, kv_chunk: int, nkv: int, window: int | None,
              triangular: bool) -> range:
    """The KV chunks query block `iq` walks: all of them, or with
    `triangular` only those overlapping the positions it can see."""
    if not triangular:
        return range(nkv)
    hi = (iq + 1) * q_chunk  # exclusive
    lo = 0 if window is None else max(0, iq * q_chunk - window + 1)
    return range(lo // kv_chunk, (hi + kv_chunk - 1) // kv_chunk)


def zigzag_blocks(n_blocks: int, parts: int) -> list[list[int]]:
    """Each of `parts` ranks' query blocks of `n_blocks` (a multiple of
    `parts`), taken in rounds of `parts` blocks: rank r takes block r of
    the even rounds and block ``parts - 1 - r`` of the odd ones (r and
    ``2 parts - 1 - r``, then ``2 parts + r``, ...), so over each pair of
    rounds every rank's blocks walk as many KV chunks under `triangular`."""
    return [[k * parts + (r if k % 2 == 0 else parts - 1 - r)
             for k in range(n_blocks // parts)] for r in range(parts)]


def query_split(s: int, parts: int, q_chunk: int | None):
    """How `parts` ranks split `s` query rows: (block rows, each rank's
    global block indices), or None where `parts` does not divide them.
    A bidirectional core (`q_chunk` None) takes one contiguous block a
    rank.  A causal one takes `zigzag_blocks` of ``q_chunk`` rows, or of
    ``s / parts`` where that is fewer, halved where a rank would take an
    odd number of them (so the zigzag pairs every block)."""
    if s % parts:
        return None
    if q_chunk is None:
        return s // parts, [[r] for r in range(parts)]
    size = min(q_chunk, s // parts)
    if (s // parts) % size:
        return None
    if (s // parts // size) % 2 and size % 2 == 0:
        size //= 2
    return size, zigzag_blocks(s // size, parts)


def query_split_attention(core, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          parts: int, q_chunk: int | None = None) -> torch.Tensor:
    """The query split's plain version, in one process: `core` on each of
    `parts` ranks' query rows (`query_split`; a causal core given
    ``q_blocks`` and ``q_chunk``), k and v whole, the outputs put back in
    sequence order."""
    b, s, h, d = q.shape
    size, order = query_split(s, parts, q_chunk)
    qb = q.reshape(b, s // size, size, h, d)
    out = [None] * (s // size)
    for blocks in order:
        rows = qb[:, blocks].reshape(b, -1, h, d)
        o = (core(rows, k, v) if q_chunk is None
             else core(rows, k, v, q_blocks=blocks, q_chunk=size))
        for i, block in zip(blocks, o.reshape(b, len(blocks), size, h, d).unbind(1)):
            out[i] = block
    return torch.stack(out, dim=1).reshape(b, s, h, d)


def full_cross_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Bidirectional (encoder / cross) attention, grouped GQA, no mask:
    q [B, Sq, H, D] against k, v [B, Skv, KV, D].  Scores, softmax and
    the PV product are f32 whatever the operands' dtype (the reference
    upcasts q, k and v and has no `cast_f32` switch here); the output
    takes q's dtype."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    scale = 1.0 / (d**0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", _group_q(q, n_kv).float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _decode_softmax_pv(qg, k_cache, v_cache, length: int, scale: float,
                       cast_f32: bool, scores: str, pv: str) -> torch.Tensor:
    """Scores in f32 (a bf16 product is exact in f32, so cast_f32=False
    gives the same product), positions at or past `length` masked to
    `NEG`, softmax, then the PV product; cast_f32=False rounds the
    probabilities to the cache dtype first, as the reference does."""
    s = torch.einsum(scores, qg.float(), k_cache.float()) * scale
    pos = torch.arange(s.shape[-1], device=s.device)
    s = torch.where(pos < length, s, NEG)
    p = torch.softmax(s, dim=-1)
    if not cast_f32:
        p = p.to(v_cache.dtype).float()
    return torch.einsum(pv, p, v_cache.float())                # [B,KV,G,1,D]


def _stacked(op):
    """A combine of one value per chunk, all in this process."""
    return lambda xs: op(torch.stack(xs), 0)


def _split_softmax_pv(qg, ks, vs, offsets, length: int, scale: float, cast_f32: bool,
                      scores: str, pv: str, combine_max, combine_sum) -> torch.Tensor:
    """`_decode_softmax_pv` over the cache in chunks (`ks`, `vs`, the
    first global position of each in `offsets`), in two passes:
    `combine_max` and `combine_sum` combine a list of one value per
    chunk over every chunk (in this process or over the ranks)."""
    s = []
    for k, off in zip(ks, offsets):
        si = torch.einsum(scores, qg.float(), k.float()) * scale
        pos = off + torch.arange(si.shape[-1], device=si.device)
        s.append(torch.where(pos < length, si, NEG))
    top = combine_max([si.amax(-1, keepdim=True) for si in s])
    e = [torch.exp(si - top) for si in s]
    total = combine_sum([ei.sum(-1, keepdim=True) for ei in e])
    out = []
    for ei, v in zip(e, vs):
        p = ei / total
        if not cast_f32:
            p = p.to(v.dtype).float()
        out.append(torch.einsum(pv, p, v.float()))
    return combine_sum(out)                                        # [B,KV,G,1,D]


#: the einsums of each cache layout: (the cache's KV-head dim, scores, PV)
_LAYOUTS = {
    "bskd": (2, "bqkgd,bskd->bkgqs", "bkgqs,bskd->bkgqd"),
    "bksd": (1, "bqkgd,bksd->bkgqs", "bkgqs,bksd->bkgqd"),
}


def _decode(q, k_caches, v_caches, offsets, length, cast_f32, layout, combine):
    b, _, h, d = q.shape
    kv_dim, scores, pv = _LAYOUTS[layout]
    n_kv = k_caches[0].shape[kv_dim]
    qg = _group_q(q, n_kv)
    if combine is None:
        out = _decode_softmax_pv(qg, k_caches[0], v_caches[0], length, 1.0 / (d**0.5),
                                 cast_f32, scores, pv)
    else:
        out = _split_softmax_pv(qg, k_caches, v_caches, offsets, length, 1.0 / (d**0.5),
                                cast_f32, scores, pv, *combine)
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, d).to(q.dtype)


def chunked_decode_attention(
    q: torch.Tensor,          # [B, 1, H, D]
    k_chunks,                 # [B, S_c, KV, D] each (bskd) or [B, KV, S_c, D] (bksd)
    v_chunks,
    length: int,
    cast_f32: bool = True,
    layout: str = "bskd",
) -> torch.Tensor:
    """`decode_attention` (or `decode_attention_bksd`) over a cache given
    as consecutive chunks of its sequence, combined in this process: the
    plain version of the sequence-parallel decode, one chunk a rank."""
    offsets, off = [], 0
    for k in k_chunks:
        offsets.append(off)
        off += k.shape[1 if layout == "bskd" else 2]
    return _decode(q, list(k_chunks), list(v_chunks), offsets, length, cast_f32, layout,
                   (_stacked(torch.amax), _stacked(torch.sum)))


def decode_attention_bksd(
    q: torch.Tensor,          # [B, 1, H, D]
    k_cache: torch.Tensor,    # [B, KV, S_cache, D]  (head-major layout)
    v_cache: torch.Tensor,
    length: int,
    cast_f32: bool = True,
    *,
    offset: int = 0,
    combine=None,
) -> torch.Tensor:
    """Head-major-cache decode attention: the cache's (B, KV) leading dims
    are exactly the einsum batch dims.  `combine`: (max, sum) over the
    ranks of a list of this rank's one value, where the cache is this
    rank's chunk of the sequence from global position `offset`."""
    return _decode(q, [k_cache], [v_cache], [offset], length, cast_f32, "bksd", combine)


def update_kv_cache_bksd(k_cache, v_cache, k_new, v_new, index: int):
    """k_new/v_new: [B, 1, KV, D] -> written at [:, :, index, :] in place."""
    k_cache[:, :, index] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, :, index] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def decode_attention(
    q: torch.Tensor,          # [B, 1, H, D]
    k_cache: torch.Tensor,    # [B, S_cache, KV, D]
    v_cache: torch.Tensor,
    length: int,              # current valid cache length (incl. new token)
    cast_f32: bool = True,
    *,
    offset: int = 0,
    combine=None,
) -> torch.Tensor:
    """Single-token attention against a (possibly partially filled) cache;
    `offset` and `combine` as `decode_attention_bksd`'s."""
    return _decode(q, [k_cache], [v_cache], [offset], length, cast_f32, "bskd", combine)


def update_kv_cache(k_cache, v_cache, k_new, v_new, index: int):
    """k_new/v_new: [B, 1, KV, D] -> written at [:, index] in place."""
    k_cache[:, index] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, index] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
