"""AdamW with global-norm clipping, a warmup-cosine schedule — plain
functions on tensors (no `torch.optim`).

Parameters, gradients and moments are dicts of tensors keyed by parameter
name.  The moments stay f32, the update is computed in f32 and cast back
to each parameter's dtype, and nothing in a step reads a value back to
the host: the clip scale, the bias corrections and the learning rate are
device tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = [
    "AdamWConfig",
    "OptState",
    "apply_updates",
    "global_norm",
    "init_opt",
    "lr_at",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: torch.Tensor           # int32 scalar on the parameters' device


def init_opt(params: dict[str, torch.Tensor]) -> OptState:
    mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    device = next(iter(params.values())).device
    return OptState(mu=mu, nu=nu, count=torch.zeros((), dtype=torch.int32, device=device))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = cfg.peak_lr * torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1
    )
    cosine = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * progress)
    )
    return torch.where(step < cfg.warmup_steps, warm, cosine)


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig,
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: OptState,
    decay: dict[str, bool] | None = None,
) -> tuple[dict[str, torch.Tensor], OptState, dict[str, torch.Tensor]]:
    """One AdamW step, written into `params` (and the moments) in place.

    `decay` names the parameters that take decoupled weight decay; by
    default those of two or more dimensions (the reference's rule on its
    own tree — `models.transformer.decay_mask` gives that set for a model
    whose reference tree stacks its layers).
    """
    if decay is None:
        decay = {n: p.dim() >= 2 for n, p in params.items()}
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = state.count + 1
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    lr = lr_at(cfg, state.count)
    for n, p in params.items():
        g = grads[n].float() * scale
        m = state.mu[n]
        v = state.nu[n]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decay[n]:  # decoupled weight decay
            step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    return params, OptState(state.mu, state.nu, count), {"grad_norm": gnorm, "lr": lr}
