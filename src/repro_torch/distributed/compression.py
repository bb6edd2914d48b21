"""Int8 gradient compression with error feedback, and the wire codecs
of the fleet telemetry format.

Gradients: per-tensor symmetric int8 quantization with an error-feedback
accumulator (`init_ef`, `compress_grads`), torch functions on dicts of
tensors keyed by parameter name.  The quantization residual is carried
into the next step, so the compressed optimizer converges to the
uncompressed trajectory (EF-SGD).  No driver calls it; the tests hold it
against the reference's.

Telemetry: the NumPy symmetric int8 quantizer and the step-axis delta +
zigzag-varint codec that `telemetry.packets` uses for SFP1/SFP2 window
payloads.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "EFState",
    "init_ef",
    "compress_grads",
    "quantize_i8",
    "dequantize_i8",
    "delta_varint_encode_i8",
    "delta_varint_decode_i8",
]

class EFState(NamedTuple):
    error: dict[str, torch.Tensor]  # residual per leaf, f32


def init_ef(params: dict[str, torch.Tensor]) -> EFState:
    return EFState(error={
        n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()
    })


def _quantize_dequantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 round-trip (round half to even, clipped
    to +-127); returns (dequantized, residual), both f32."""
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, g - deq


def compress_grads(
    grads: dict[str, torch.Tensor], ef: EFState
) -> tuple[dict[str, torch.Tensor], EFState]:
    """Apply EF-int8 to every gradient leaf: (the compressed gradients to
    feed the optimizer, the updated error state)."""
    deq, res = {}, {}
    for n, g in grads.items():
        deq[n], res[n] = _quantize_dequantize(g.to(torch.float32) + ef.error[n])
    return deq, EFState(error=res)


# ---------------------------------------------------------------------------
# Symmetric int8 codec (the fleet telemetry wire format in
# telemetry.packets / fleet.ingest)
# ---------------------------------------------------------------------------


def quantize_i8(
    x: np.ndarray, *, axis: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization: q = round(x / scale), scale = amax/127.

    `axis=None` is the per-tensor scale of the gradient path; the telemetry
    wire format passes the stage axis so each stage column keeps its own
    dynamic range (a 100 ms backward must not flatten a 2 ms residual).

    Returns (q int8 same-shape, scale float64 — scalar or per-slice).
    """
    xf = np.asarray(x, np.float64)
    if axis is None:
        amax = np.abs(xf).max()
    else:
        # successive leading-axis maxes are bit-identical to the joint
        # reduction but keep every pass contiguous — the joint
        # max(axis=(0, 1)) form is ~6x slower on [N, R, S] windows (it
        # reduces down strided stage columns), and this sits on the
        # evidence-packet encode hot path.
        amax = np.moveaxis(np.abs(xf), axis % xf.ndim, -1)
        while amax.ndim > 1:
            amax = amax.max(axis=0)
    scale = np.maximum(amax, 1e-12) / 127.0
    s = scale if axis is None else np.expand_dims(
        scale, tuple(i for i in range(xf.ndim) if i != axis % xf.ndim)
    )
    # same values as clip(round(x / s)) with two fewer temporaries
    q = xf / s
    np.rint(q, out=q)
    np.clip(q, -127, 127, out=q)
    return q.astype(np.int8), scale


def dequantize_i8(
    q: np.ndarray, scale: np.ndarray, *, axis: int | None = None
) -> np.ndarray:
    """Inverse of `quantize_i8` (up to the quantization error)."""
    qf = np.asarray(q, np.float64)
    if axis is None:
        return qf * float(scale)
    s = np.expand_dims(
        np.asarray(scale, np.float64),
        tuple(i for i in range(qf.ndim) if i != axis % qf.ndim),
    )
    return qf * s


# ---------------------------------------------------------------------------
# Step-axis delta + zigzag-varint codec for int8 windows (the SFP2 wire
# payload in telemetry.packets).  Deltas are taken along the leading
# (step) axis independently per trailing cell, so each stage column keeps
# its own smooth stream; zigzagged deltas of int8 values span [0, 508] and
# therefore fit LEB128 varints of at most two bytes, which is what lets
# both directions stay fully numpy-vectorized.
# ---------------------------------------------------------------------------


def _varint_encode_u16(vals: np.ndarray) -> bytes:
    """LEB128-encode a flat array of values < 2**14 (<= 2 bytes each)."""
    v = np.asarray(vals, np.uint16).ravel()
    if v.size == 0:
        return b""
    two = v >= 0x80
    # interleaved (low, high) byte planes; boolean compress keeps the low
    # byte always and the high byte only for two-byte values, in C order —
    # one pass instead of a cumsum + two scatters.
    pair = np.empty((v.size, 2), np.uint8)
    pair[:, 0] = (v & 0x7F) | (two << 7)
    pair[:, 1] = v >> 7
    keep = np.empty((v.size, 2), bool)
    keep[:, 0] = True
    keep[:, 1] = two
    return pair[keep].tobytes()


def _varint_decode_u16(buf: np.ndarray, count: int) -> np.ndarray:
    """Inverse of `_varint_encode_u16`; strict: the buffer must hold exactly
    `count` well-formed varints (truncation, over-length varints and
    trailing bytes all raise ValueError)."""
    b = np.asarray(buf, np.uint8).ravel()
    if count == 0:
        if b.size:
            raise ValueError("varint stream has trailing bytes")
        return np.zeros(0, np.uint32)
    if b.size == 0 or (b[-1] & 0x80):
        raise ValueError("truncated varint stream")
    cont = (b & 0x80) != 0
    starts_mask = np.empty(b.size, bool)
    starts_mask[0] = True
    np.logical_not(cont[:-1], out=starts_mask[1:])
    starts = np.flatnonzero(starts_mask)
    if starts.size != count:
        raise ValueError(
            f"varint stream holds {starts.size} values, expected {count}"
        )
    vals = (b[starts] & 0x7F).astype(np.uint16)
    two = cont[starts]
    second = b[starts[two] + 1]
    if (second & 0x80).any():
        raise ValueError("varint longer than 2 bytes")
    vals[two] |= second.astype(np.uint16) << 7
    return vals


def delta_varint_encode_i8(q: np.ndarray) -> bytes:
    """Delta the int8 array `q` along its leading (step) axis per trailing
    cell, zigzag, and LEB128-encode.  Lossless: `delta_varint_decode_i8`
    recovers `q` exactly."""
    qi = np.asarray(q, np.int8).astype(np.int16)
    d = np.diff(qi, axis=0, prepend=np.zeros((1, *qi.shape[1:]), np.int16))
    z = (d << 1) ^ (d >> 15)  # zigzag: [-254, 254] -> [0, 508]
    return _varint_encode_u16(z)


def delta_varint_decode_i8(buf, shape: tuple[int, ...]) -> np.ndarray:
    """Inverse of `delta_varint_encode_i8` for a declared `shape`.  Strict:
    raises ValueError on truncation, trailing bytes, or any prefix sum
    escaping the int8 range (corrupt deltas never wrap silently)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 0
    z = _varint_decode_u16(np.frombuffer(buf, np.uint8), n).astype(np.int32)
    d = (z >> 1) ^ -(z & 1)  # un-zigzag
    q = np.cumsum(d.reshape(shape), axis=0, dtype=np.int32) if n else \
        np.zeros(shape, np.int32)
    if n and (q.min() < -128 or q.max() > 127):
        raise ValueError("delta stream escapes int8 range (corrupt payload)")
    return q.astype(np.int8)
