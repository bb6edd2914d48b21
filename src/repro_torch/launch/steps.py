"""The train step on one device.

`build_train_step` returns one function, built once and called every
step: loss and gradients (with optional microbatch accumulation), the
global-norm clip and AdamW, all queued on the parameters' device with no
read-back to the host.  The reference's mesh, sharding plans and ZeRO-1
optimizer-state sharding have no counterpart on one card; the prefill
and serve step builders belong to the serving slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.model_zoo import Model
from ..models.transformer import TransformerLM, decay_mask
from ..optim.adamw import AdamWConfig, OptState, apply_updates, init_opt

__all__ = ["TrainState", "build_train_step", "init_train_state"]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer
    state and the step count (an int32 tensor on the device)."""

    params: TransformerLM
    opt: OptState
    step: torch.Tensor

    def tree(self) -> dict[str, Any]:
        """The state as a tree of tensors, for `checkpoint.save_checkpoint`."""
        return {
            "params": dict(self.params.named_parameters()),
            "opt": {"mu": self.opt.mu, "nu": self.opt.nu, "count": self.opt.count},
            "step": self.step,
        }

    @torch.no_grad()
    def load(self, tree: dict[str, Any]) -> None:
        """Copy a restored `tree()` into this state."""
        for name, p in self.params.named_parameters():
            p.copy_(tree["params"][name])
        for name in self.opt.mu:
            self.opt.mu[name].copy_(tree["opt"]["mu"][name])
            self.opt.nu[name].copy_(tree["opt"]["nu"][name])
        self.opt = self.opt._replace(count=tree["opt"]["count"].clone())
        self.step = tree["step"].clone()


def init_train_state(
    model: Model, generator: torch.Generator | None = None, device="cuda"
) -> TrainState:
    module = model.init(generator=generator, device=device)
    return TrainState(
        params=module,
        opt=init_opt(dict(module.named_parameters())),
        step=torch.zeros((), dtype=torch.int32, device=module.embed.device),
    )


def build_train_step(
    model: Model,
    opt_cfg: AdamWConfig | None = None,
    *,
    accum_steps: int = 1,
    triangular: bool = False,
):
    """Fused train step: grads -> clip -> AdamW, optional microbatch accum.

    ``train_step(state, batch) -> (state, metrics)``; `metrics` holds
    device tensors (``loss``, ``grad_norm``, ``lr``).  With
    ``accum_steps > 1`` each batch leaf is [accum, micro, ...] and the
    gradients are summed in f32 over the microbatches, then averaged.
    """
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(state: TrainState, batch: dict):
        params = dict(state.params.named_parameters())
        leaves = list(params.values())

        def value_and_grad(b):
            loss = model.loss(state.params, b, triangular=triangular)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        if accum_steps > 1:
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves]
            for i in range(accum_steps):
                micro_loss, micro_grads = value_and_grad({k: v[i] for k, v in batch.items()})
                loss = loss + micro_loss
                grads = [a + g for a, g in zip(grads, micro_grads)]
            loss = loss / accum_steps
            grads = [g / accum_steps for g in grads]
        else:
            loss, grads = value_and_grad(batch)
        _, opt, om = apply_updates(
            opt_cfg, params, dict(zip(params, grads)), state.opt,
            decay_mask(state.params),
        )
        metrics = {"loss": loss, **om}
        return TrainState(params=state.params, opt=opt, step=state.step + 1), metrics

    return train_step
