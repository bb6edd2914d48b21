"""The products of activations and weights, by precision.

``float32`` is the reference.  ``fp8`` is the control: the same model
with both operands of every such product rounded to float8 (e4m3, one
scale per tensor, the amax mapped to 448) before an f32 product, the
step a later change of the bf16 program to fp8 GEMMs would take.  The
rounding passes gradients straight through, so the backward products
read the rounded operands, as an fp8 GEMM's backward would.
"""
from __future__ import annotations

import torch

__all__ = ["LINEAR"]

_E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / _E4M3_MAX
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (rounded - t).detach()


LINEAR = {
    "float32": lambda x, w: x @ w,
    "fp8": lambda x, w: _fp8(x) @ _fp8(w),
}
