"""The reference's first training steps and the readings the check compares.

From the benchmark's weights (drawn again from the seed) and the
batches the program was fed, the reference takes `len(batches)` steps
of the configuration's training: the mean token cross-entropy, its
gradient in f32, the global-norm clip and AdamW with the warmup-cosine
schedule, as the configuration's ``optimizer`` group states them.

Storage follows the configuration: each parameter is held in its stated
type (bf16 for the matrices and norms, f32 for the SSM's ``A_log``,
``D`` and ``dt_bias``) between steps, so each update is rounded to that
type, as a model stored in bf16 is; every operation inside a step is
f32.  Decoupled weight decay falls on every parameter but those the
optimizer group lists under ``no_decay``.

Readings: each step's loss; each leaf's norm of the first gradient as
the optimizer takes it (after the clip); each leaf's norm of its change
over all the steps.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..weights import make_weights
from .model import batch_loss
from .params import Arch, param_layout
from .precision import LINEAR

__all__ = ["lr_at", "train_readings"]


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of step `step` (0 first): linear warmup to the
    peak, then a cosine to ``min_lr`` at ``decay_steps``."""
    peak, low = opt["peak_lr"], opt["min_lr"]
    warmup, decay = opt["warmup_steps"], opt["decay_steps"]
    if step < warmup:
        return peak * min((step + 1) / max(warmup, 1), 1.0)
    progress = min(max((step - warmup) / max(decay - warmup, 1), 0.0), 1.0)
    return low + 0.5 * (peak - low) * (1 + math.cos(math.pi * progress))


@contextlib.contextmanager
def _no_tf32():
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def train_readings(config: dict, seed: int, batches: list[dict], device,
                   precision: str = "float32") -> dict:
    """``{"losses": [...], "first_grad": {leaf: norm}, "change": {leaf:
    norm}}`` of the reference's steps on `batches` (numpy ``tokens`` and
    ``labels``) from the weights of `seed`."""
    arch = Arch.from_config(config)
    opt = config["optimizer"]
    layout = param_layout(arch)
    stored = {name: dtype for name, _, dtype in layout}
    linear = LINEAR[precision]
    with _no_tf32():
        params = {n: w.float().requires_grad_(True)
                  for n, w in make_weights(layout, seed, device).items()}
        mu = {n: torch.zeros_like(p) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
        decay = {n: n not in opt["no_decay"] for n in params}
        b1, b2 = opt["b1"], opt["b2"]
        losses, first = [], {}
        for k, batch in enumerate(batches):
            tokens = torch.as_tensor(batch["tokens"], device=device)
            labels = torch.as_tensor(batch["labels"], device=device)
            losses.append(batch_loss(arch, linear, params, tokens, labels))
            with torch.no_grad():
                norm = torch.sqrt(sum(p.grad.pow(2).sum() for p in params.values()))
                scale = min(1.0, opt["clip_norm"] / max(float(norm), 1e-12))
                if k == 0:
                    first = {n: float(p.grad.norm()) * scale for n, p in params.items()}
                lr = lr_at(opt, k)
                b1c, b2c = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
                for n, p in params.items():
                    g = p.grad * scale
                    mu[n].mul_(b1).add_(g, alpha=1 - b1)
                    nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    step = (mu[n] / b1c) / (torch.sqrt(nu[n] / b2c) + opt["eps"])
                    if decay[n]:
                        step = step + opt["weight_decay"] * p
                    p.copy_((p - lr * step).to(stored[n]).float())
                    p.grad = None
        del mu, nu
        with torch.no_grad():
            start = make_weights(layout, seed, device)
            change = {n: float((params[n] - start[n].float()).norm()) for n in params}
    return {"losses": losses, "first_grad": first, "change": change}
