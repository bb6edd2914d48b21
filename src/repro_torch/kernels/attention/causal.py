"""Causal attention on the card: the hand-written kernel of
``csrc/causal_attention.cu`` and its plain PyTorch version.

`causal_attention` computes what `models.attention.chunked_causal_attention`
computes, for CUDA tensors: q [B, Sq, H, D] against k, v [B, S, KV, D],
GQA with G = H / KV query heads a KV head, an optional sliding `window`
and the query split's ``q_blocks`` (global indices of the ``q_chunk``-row
blocks q holds).  ``cast_f32=False`` on bf16 inputs (the probabilities
rounded to bf16 before P.V) raises: no configuration runs it on the card,
so the kernel has no instance for it; on f32 inputs it rounds nothing.  One launch forward; when a gradient is wanted it also keeps the
row log-sum-exp and the f32 output, and the backward is two launches (dQ
with delta = rowsum(dO * O), then dK and dV), deterministic, with no
atomics.  Scores and probabilities never leave the chip, so nothing of P
is stored: the backward recomputes it from the log-sum-exp, which is the
per-query-block remat of ``attn_remat`` inside the kernel.

Precision is the plain walk's with another order of f32 sums: products of
two bf16 values take one bf16 MMA (exact in f32); P, dS and every operand
of an f32 input enter as three bf16 parts (`split_parts`), whose sum is
the f32 value.  One library per (head_dim, input dtype) is built on first
use, without ``-ftz=true`` (the source's note says why).

`causal_attention_ref` is the kernel's arithmetic in plain PyTorch on any
device: a tile walk with the kernel's skips, the saved log-sum-exp, the
split products and the delta / log-sum-exp backward, as a
`torch.autograd.Function`.  The tests hold it against the plain walk and
autograd on the CPU, and the kernel against it on the card.  No model path
calls it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple, Sequence

import torch

from .. import _lib

__all__ = [
    "HEAD_DIMS",
    "causal_attention",
    "causal_attention_ref",
    "launches",
    "library_flags",
    "split_parts",
]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCE = "causal_attention.cu"
#: the head sizes a library is built for (every config's, the reduced 16 too)
HEAD_DIMS = (16, 64, 128, 256)
_DTYPES = (torch.bfloat16, torch.float32)
#: launches of each kernel, counted by `_lib.count_launch`
launches = {"forward": 0, "backward_dq": 0, "backward_dkv": 0}


def library_flags(head_dim: int, dtype: torch.dtype) -> tuple[str, ...]:
    """nvcc flags of the (head_dim, dtype) instance: no ``-ftz=true``."""
    return (*_lib.NVCC_ARCH_FLAGS, f"-DHEAD_DIM={head_dim}",
            f"-DINPUT_F32={int(dtype == torch.float32)}")


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i, i, i, i, i, i, i, f]  # qc, B, Sq, S, H, KV, window, scale
    lib.causal_attention_forward.argtypes = [p] * 7 + shape + [p]
    lib.causal_attention_dq.argtypes = [p] * 9 + shape + [p]
    lib.causal_attention_dkv.argtypes = [p] * 9 + shape + [p]
    for name in ("causal_attention_forward", "causal_attention_dq", "causal_attention_dkv",
                 "causal_attention_query_tile", "causal_attention_key_tile"):
        getattr(lib, name).restype = i
    lib.causal_attention_query_tile.argtypes = []
    lib.causal_attention_key_tile.argtypes = []
    lib.causal_attention_error_string.argtypes = [i]
    lib.causal_attention_error_string.restype = ctypes.c_char_p


@functools.cache
def _library(head_dim: int, dtype: torch.dtype):
    """The (head_dim, dtype) instance and its tiles: (library, the fewest
    query rows of a CTA, the keys of a dK/dV CTA)."""
    lib = _lib.load_library(_SOURCE, _bind, csrc=CSRC, flags=library_flags(head_dim, dtype))
    return lib, lib.causal_attention_query_tile(), lib.causal_attention_key_tile()


class _Spec(NamedTuple):
    """What a call computes besides its tensors."""

    window: int            # 0: none
    qblk: torch.Tensor | None  # int32 block indices on the device, or None
    q_chunk: int           # rows of a block of `qblk`
    scale: float


def _check(q, k, v) -> None:
    """Raise unless the kernel takes these inputs, naming why not."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"causal_attention: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"causal_attention: {name} is on {t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"causal_attention: {name} has shape {tuple(t.shape)}, not 4-D")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"causal_attention: {name} has dtype {t.dtype}; the kernel takes "
                             f"q, k and v all bfloat16 or all float32")
    b, _, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"causal_attention: head_dim {d} is not one of {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"causal_attention: k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"causal_attention: {h} query heads do not group over "
                         f"{k.shape[2]} KV heads")


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernel's vector loads read it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"causal_attention {what} launch failed: "
                           f"{lib.causal_attention_error_string(err).decode()}")


def _shape_args(q, k, spec: _Spec):
    b, sq, h, _ = q.shape
    qblk = spec.qblk.data_ptr() if spec.qblk is not None else None
    return qblk, [spec.q_chunk, b, sq, k.shape[1], h, k.shape[2], spec.window, spec.scale]


def _grid_rows(rows: int, tile: int, what: str) -> None:
    if (rows + tile - 1) // tile > 65535:
        raise ValueError(f"causal_attention: {rows} {what} make more than 65,535 tiles of "
                         f"{tile}, the grid's limit")


def _forward(q, k, v, spec: _Spec, save: bool):
    lib, query_tile, _ = _library(q.shape[3], q.dtype)
    b, sq, h, d = q.shape
    _grid_rows(sq * (h // k.shape[2]), query_tile, "query rows")
    out = torch.empty_like(q)
    o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device) if save else None
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if save else None
    qblk, shape = _shape_args(q, k, spec)
    err = lib.causal_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if o32 is None else o32.data_ptr(), None if lse is None else lse.data_ptr(),
        qblk, *shape, torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, err, "forward")
    _lib.count_launch(launches, "forward")
    return out, o32, lse


def _backward(q, k, v, o32, lse, dout, spec: _Spec):
    lib, _, key_tile = _library(q.shape[3], q.dtype)
    _grid_rows(k.shape[1], key_tile, "keys")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    qblk, shape = _shape_args(q, k, spec)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, dout)]
    err = lib.causal_attention_dq(*ptrs, o32.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                  dq.data_ptr(), qblk, *shape, stream)
    _raise(lib, err, "dq")
    _lib.count_launch(launches, "backward_dq")
    err = lib.causal_attention_dkv(*ptrs, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), qblk, *shape, stream)
    _raise(lib, err, "dk/dv")
    _lib.count_launch(launches, "backward_dkv")
    return dq, dk, dv


class _CausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, spec: _Spec):
        out, o32, lse = _forward(q, k, v, spec, save=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o32, lse, _ready(dout.to(q.dtype)), ctx.spec)
        return dq, dk, dv, None


def _spec(q, k, window, cast_f32, q_blocks, q_chunk) -> _Spec:
    """The call's `_Spec`; raises for ``cast_f32=False`` on bf16 inputs
    and unless q's rows are positions of k's: all of them in order, or
    the ``q_chunk``-row blocks `q_blocks`."""
    if not cast_f32 and q.dtype == torch.bfloat16:
        raise ValueError("causal_attention: cast_f32=False on bfloat16 inputs rounds the "
                         "probabilities to bf16, which no configuration runs on the card "
                         "and the kernel does not build")
    sq, s = q.shape[1], k.shape[1]
    qblk = None
    if q_blocks is None:
        if sq != s:
            raise ValueError(f"causal_attention: {sq} query rows and {s} keys, and no q_blocks")
    else:
        q_blocks = list(q_blocks)
        if not q_chunk or len(q_blocks) * q_chunk != sq or not all(
                0 <= i and (i + 1) * q_chunk <= s for i in q_blocks):
            raise ValueError(f"causal_attention: q_blocks {q_blocks} of {q_chunk} rows are not "
                             f"the {sq} query rows among {s} keys")
        qblk = torch.tensor(q_blocks, dtype=torch.int32).to(q.device)
    return _Spec(int(window or 0), qblk, int(q_chunk or 1),
                 1.0 / (q.shape[3]**0.5))


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int | None = None,
    cast_f32: bool = True,
    q_blocks: Sequence[int] | None = None,
    q_chunk: int | None = None,
) -> torch.Tensor:
    """The kernel: causal attention of q [B, Sq, H, D] over k, v [B, S, KV,
    D] on a CUDA device; q's rows are positions 0..Sq-1 or, with
    `q_blocks`, the ``q_chunk``-row blocks of those global indices.
    Raises, with the reason, for inputs the kernel does not take."""
    _check(q, k, v)
    q, k, v = _ready(q), _ready(k), _ready(v)
    spec = _spec(q, k, window, cast_f32, q_blocks, q_chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _CausalAttention.apply(q, k, v, spec)
    return _forward(q, k, v, spec, save=False)[0]


# ---------------------------------------------------------------------------
# the plain version of the kernel's arithmetic

#: the kernel's tiles at head_dim 64 in bf16 (the mirror's defaults)
REF_BLOCK_M, REF_BLOCK_N = 64, 64


def split_parts(x: torch.Tensor, n: int = 3) -> list[torch.Tensor]:
    """x as `n` bf16 values (held in f32), largest first: hi = bf16(x),
    mid = bf16(x - hi), lo = bf16(x - hi - mid).  For n = 3 they sum to
    x exactly (8 + 8 + 8 bits of its 24) wherever the parts are normal,
    |x| >= 2**-110; below that lo loses bits a product could not show."""
    parts, rest = [], x.float()
    for _ in range(n):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


def _n_parts(dtype: torch.dtype) -> int:
    """bf16 parts of an operand held in `dtype`: one bf16 value is exact."""
    return 1 if dtype == torch.bfloat16 else 3


def _split_mm(a: torch.Tensor, b: torch.Tensor, na: int, nb: int) -> torch.Tensor:
    """a @ b in f32 from bf16 parts, as the kernel's MMAs take it: the
    part products with i + j <= 2, each exact in f32."""
    pa, pb = split_parts(a, na), split_parts(b, nb)
    out = None
    for i in range(na):
        for j in range(nb):
            if i + j <= 2:
                t = pa[i] @ pb[j]
                out = t if out is None else out + t
    return out


def _rows(x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, Sq, H, D] -> [B, KV, Sq * G, D]: a KV head's query heads
    flattened with the positions, position-major, as the kernel's rows."""
    b, sq, h, d = x.shape
    g = h // n_kv
    return x.reshape(b, sq, n_kv, g, d).transpose(1, 2).reshape(b, n_kv, sq * g, d)


def _unrows(x: torch.Tensor, sq: int, h: int) -> torch.Tensor:
    b, n_kv, _, d = x.shape
    return x.reshape(b, n_kv, sq, h // n_kv, d).transpose(1, 2).reshape(b, sq, h, d)


def _positions(sq: int, g: int, q_blocks, q_chunk: int, device) -> torch.Tensor:
    """The global position of each flattened row."""
    lp = torch.arange(sq, device=device)
    if q_blocks is not None:
        blk = torch.tensor(list(q_blocks), device=device)
        lp = blk[lp // q_chunk] * q_chunk + lp % q_chunk
    return lp.repeat_interleave(g)


def _visible(pos: torch.Tensor, keys: torch.Tensor, window: int) -> torch.Tensor:
    vis = keys[None, :] <= pos[:, None]
    if window:
        vis &= pos[:, None] - keys[None, :] < window
    return vis


def _walk(pos: torch.Tensor, n_keys: int, window: int, bm: int, bn: int):
    """(row slice, positions, key slice, keys) of every (query tile, key
    tile) pair the kernel computes: key tiles from the first a tile's
    window reaches to the one holding its last position."""
    for r0 in range(0, pos.numel(), bm):
        p = pos[r0:r0 + bm]
        lo = max(0, int(p.min()) - window + 1) // bn if window else 0
        for j in range(lo, int(p.max()) // bn + 1):
            keys = torch.arange(j * bn, min(j * bn + bn, n_keys), device=pos.device)
            yield slice(r0, r0 + bm), p, slice(j * bn, j * bn + bn), keys


class _CausalAttentionRef(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, q_blocks, q_chunk, bm, bn):
        b, sq, h, d = q.shape
        n_kv = k.shape[2]
        scale = 1.0 / (d**0.5)
        nq, nk = _n_parts(q.dtype), _n_parts(k.dtype)
        qr, kr, vr = _rows(q, n_kv).float(), k.transpose(1, 2).float(), v.transpose(1, 2).float()
        pos = _positions(sq, h // n_kv, q_blocks, q_chunk, q.device)
        rows = qr.shape[2]
        m = torch.full((b, n_kv, rows), float("-inf"), device=q.device)
        l = torch.zeros((b, n_kv, rows), device=q.device)
        acc = torch.zeros((b, n_kv, rows, d), device=q.device)
        for rs, p, ks, keys in _walk(pos, k.shape[1], window, bm, bn):
            s = _split_mm(qr[:, :, rs], kr[:, :, ks].transpose(-1, -2), nq, nk) * scale
            s = s.masked_fill(~_visible(p, keys, window), float("-inf"))
            mn = torch.maximum(m[:, :, rs], s.amax(-1))
            use = torch.where(mn == float("-inf"), torch.zeros_like(mn), mn)
            corr = torch.exp(m[:, :, rs] - use)
            m[:, :, rs] = mn
            pr = torch.exp(s - use[..., None])
            l[:, :, rs] = l[:, :, rs] * corr + pr.sum(-1)
            acc[:, :, rs] = acc[:, :, rs] * corr[..., None] + _split_mm(pr, vr[:, :, ks], 3, nk)
        o32 = acc / l[..., None]
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.args = (window, q_blocks, q_chunk, bm, bn)
        return _unrows(o32, sq, h).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        window, q_blocks, q_chunk, bm, bn = ctx.args
        b, sq, h, d = q.shape
        n_kv = k.shape[2]
        scale = 1.0 / (d**0.5)
        nq, nk = _n_parts(q.dtype), _n_parts(k.dtype)
        dout = dout.to(q.dtype)
        ndo = _n_parts(dout.dtype)
        qr, kr, vr = _rows(q, n_kv).float(), k.transpose(1, 2).float(), v.transpose(1, 2).float()
        dor = _rows(dout, n_kv).float()
        delta = (dor * o32).sum(-1)
        pos = _positions(sq, h // n_kv, q_blocks, q_chunk, q.device)
        dq, dk, dv = torch.zeros_like(qr), torch.zeros_like(kr), torch.zeros_like(vr)
        for rs, p, ks, keys in _walk(pos, k.shape[1], window, bm, bn):
            qt, kt, vt, dot = qr[:, :, rs], kr[:, :, ks], vr[:, :, ks], dor[:, :, rs]
            s = _split_mm(qt, kt.transpose(-1, -2), nq, nk) * scale
            pr = torch.exp(s - lse[:, :, rs, None])
            pr = pr.masked_fill(~_visible(p, keys, window), 0.0)
            dp = _split_mm(dot, vt.transpose(-1, -2), ndo, nk)
            ds = pr * (dp - delta[:, :, rs, None]) * scale
            dq[:, :, rs] += _split_mm(ds, kt, 3, nk)
            dk[:, :, ks] += _split_mm(ds.transpose(-1, -2), qt, 3, nq)
            dv[:, :, ks] += _split_mm(pr.transpose(-1, -2), dot, 3, ndo)
        return (_unrows(dq, sq, h).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype), None, None, None, None, None)


def causal_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int | None = None,
    q_blocks: Sequence[int] | None = None,
    q_chunk: int | None = None,
    block_m: int = REF_BLOCK_M,
    block_n: int = REF_BLOCK_N,
) -> torch.Tensor:
    """`causal_attention`'s arithmetic in plain PyTorch, on any device:
    tiles of `block_m` flattened query rows and `block_n` keys.  P enters
    P.V unrounded, as ``cast_f32=True`` has it."""
    q_blocks = None if q_blocks is None else tuple(q_blocks)
    return _CausalAttentionRef.apply(q, k, v, int(window or 0), q_blocks, int(q_chunk or 1),
                                     block_m, block_n)
