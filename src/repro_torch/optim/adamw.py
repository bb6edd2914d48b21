"""AdamW with global-norm clipping, a warmup-cosine schedule — plain
functions on tensors (no `torch.optim`).

Parameters, gradients and moments are dicts of tensors keyed by parameter
name.  The moments stay f32, the update is computed in f32 and cast back
to each parameter's dtype, and nothing in a step reads a value back to
the host: the clip scale, the bias corrections and the learning rate are
device tensors.

The update runs over groups of leaves with multi-tensor (``_foreach``)
ops, a few launches a group where a loop over the leaves took some
twenty a leaf; each op is the loop's elementwise op in the loop's order,
so every leaf gets the same bits.  A group holds at most as many
elements as the largest leaf (a larger leaf alone), so its f32
temporaries never outgrow those the largest leaf needs by itself.
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
    grad_norm: torch.Tensor | None = None,
) -> tuple[dict[str, torch.Tensor], OptState, dict[str, torch.Tensor]]:
    """One AdamW step, written into `params` (and the moments) in place.

    `decay` names the parameters that take decoupled weight decay; by
    default those of two or more dimensions (the reference's rule on its
    own tree — `models.transformer.decay_mask` gives that set for a model
    whose reference tree stacks its layers).  `grad_norm` is the global
    norm the clip reads, by default that of `grads`: a sharded step
    passes the norm of the whole gradients with its shards of them.
    """
    if decay is None:
        decay = {n: p.dim() >= 2 for n, p in params.items()}
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = state.count + 1
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    lr = lr_at(cfg, state.count)
    for group in _groups(params, decay):
        ps = [params[n] for n in group]
        g = torch._foreach_mul([grads[n].float() for n in group], scale)
        m = [state.mu[n] for n in group]
        v = [state.nu[n] for n in group]
        torch._foreach_mul_(m, cfg.b1)                  # m = b1 m + (1 - b1) g
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        gg = torch._foreach_mul(g, 1 - cfg.b2)          # v = b2 v + (1 - b2) g g
        torch._foreach_mul_(gg, g)
        del g
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, gg)
        del gg
        step = torch._foreach_div(m, b1c)               # (m / b1c) / (sqrt(v / b2c) + eps)
        root = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(root)
        torch._foreach_add_(root, cfg.eps)
        torch._foreach_div_(step, root)
        del root
        pf = [p.float() for p in ps]
        if decay[group[0]]:  # decoupled weight decay
            torch._foreach_add_(step, torch._foreach_mul(pf, cfg.weight_decay))
        torch._foreach_mul_(step, lr)
        torch._foreach_copy_(ps, torch._foreach_sub(pf, step))
    return params, OptState(state.mu, state.nu, count), {"grad_norm": gnorm, "lr": lr}


def _groups(params: dict[str, torch.Tensor], decay: dict[str, bool]) -> list[list[str]]:
    """The leaves in runs of one decay flag, each run at most as many
    elements as the largest leaf."""
    cap = max((p.numel() for p in params.values()), default=0)
    groups: list[list[str]] = []
    size = 0
    for n, p in params.items():
        if not groups or decay[n] != decay[groups[-1][0]] or size + p.numel() > cap:
            groups.append([])
            size = 0
        groups[-1].append(n)
        size += p.numel()
    return groups
