"""The benchmark's weights, drawn from ``--seed`` on the device.

One generator on the device draws every weight in the type it is stored
in: the normal leaves of each type in a few large calls into one flat
buffer, then the few uniform leaves of the SSM.  The same seed on the
same device type gives the same tensors, so the program is loaded with
them and the reference draws them again after the window instead of
keeping a copy.

Initial values by leaf: norm scales and the SSM's ``D`` one, the conv
bias zero, the embedding normal with std 0.02, the SSM's ``A_log`` the
log of U(1, 16) and ``dt_bias`` the inverse softplus of a step drawn
log-uniform in [1e-3, 1e-1] (Mamba-2's initialisation), the conv weight
normal with std 1/sqrt(width), every other matrix normal with std
1/sqrt(fan_in).
"""
from __future__ import annotations

import math

import torch

__all__ = ["make_weights"]

#: elements per draw: a whole model is a few calls
_CHUNK = 1 << 30


def _rule(name: str, shape: tuple[int, ...]):
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "gate_norm_scale", "D"):
        return ("fill", 1.0)
    if leaf == "conv_b":
        return ("fill", 0.0)
    if leaf == "A_log":
        return ("uniform", "A_log")
    if leaf == "dt_bias":
        return ("uniform", "dt_bias")
    if name == "embed":
        return ("normal", 0.02)
    return ("normal", 1.0 / math.sqrt(shape[0]))


@torch.no_grad()
def make_weights(layout, seed: int, device) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for `layout` (`reference.params.param_layout`)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: dict[str, torch.Tensor] = {}
    rules = [(name, shape, dtype, _rule(name, shape)) for name, shape, dtype in layout]
    for dtype in sorted({d for *_, d, r in rules if r[0] == "normal"}, key=str):
        leaves = [(n, s, r[1]) for n, s, d, r in rules if r[0] == "normal" and d == dtype]
        total = sum(math.prod(s) for _, s, _ in leaves)
        flat = torch.empty(total, dtype=dtype, device=device)
        for start in range(0, total, _CHUNK):
            flat[start:start + _CHUNK].normal_(generator=gen)
        offset = 0
        for name, shape, std in leaves:
            size = math.prod(shape)
            out[name] = flat[offset:offset + size].view(shape).mul_(std)
            offset += size
    for name, shape, dtype, (kind, arg) in rules:
        if kind == "fill":
            out[name] = torch.full(shape, arg, dtype=dtype, device=device)
        elif kind == "uniform":
            u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
            if arg == "A_log":
                value = torch.log(1.0 + 15.0 * u)
            else:
                dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
                value = dt + torch.log(-torch.expm1(-dt))
            out[name] = value.to(dtype)
    return {name: out[name] for name, _, _ in layout}
