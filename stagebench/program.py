"""The system under test: the port's model, train step and state.

The harness reaches the program only here.  It builds the port's model
from the configuration's ``model`` group, allocates its parameters
empty on the device (the port's own initialiser draws on the host),
loads the benchmark's weights into them by name, and builds the step as
the port's train driver does: `build_train_step` on the one-device
`make_local_mesh` under `BASELINE_PLAN`, over a `TrainState` with
`init_opt`'s zero moments.  The readings the check compares are taken
from that state.
"""
from __future__ import annotations

import dataclasses

import torch

from .reference.params import Arch, param_layout
from .weights import make_weights

__all__ = ["Program"]


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        from repro_torch.configs import get_config
        from repro_torch.distributed.sharding import BASELINE_PLAN
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.launch.steps import build_train_step
        from repro_torch.models import build_model
        from repro_torch.optim.adamw import AdamWConfig

        self.device = torch.device(device)
        seq = traffic["seq"]
        cfg = dataclasses.replace(get_config(config["arch"]), **config["model"])
        cfg = dataclasses.replace(  # as the train driver fits the chunks to the sequence
            cfg,
            attn_q_chunk=min(cfg.attn_q_chunk, seq),
            attn_kv_chunk=min(cfg.attn_kv_chunk, seq),
            ssm_chunk=min(cfg.ssm_chunk, seq),
        )
        self.layout = param_layout(Arch.from_config(config))
        self.model = build_model(cfg)
        with torch.device("meta"):
            module = self.model.init(device="meta")
        have = [(n, tuple(p.shape), p.dtype) for n, p in module.named_parameters()]
        want = [(n, tuple(s), d) for n, s, d in self.layout]
        if have != want:
            diff = sorted(set(have) ^ set(want))[:4]
            raise ValueError(f"the program's parameters differ from the configuration's: {diff}")
        self.module = module.to_empty(device=self.device)
        opt = {k: v for k, v in config["optimizer"].items() if k != "no_decay"}
        self.b1 = opt["b1"]
        self.step, self.shardings = build_train_step(
            self.model, make_local_mesh(device=self.device), BASELINE_PLAN, AdamWConfig(**opt))

    @torch.no_grad()
    def load(self, seed: int):
        """A fresh `TrainState` holding the weights of `seed`."""
        from repro_torch.launch.steps import TrainState, shard_train_state
        from repro_torch.optim.adamw import init_opt

        weights = make_weights(self.layout, seed, self.device)
        for name, p in self.module.named_parameters():
            p.copy_(weights[name])
        del weights
        params = dict(self.module.named_parameters())
        state = TrainState(params=self.module, opt=init_opt(params),
                           step=torch.zeros((), dtype=torch.int32, device=self.device))
        return shard_train_state(state, self.shardings)

    @torch.no_grad()
    def first_grad(self, state) -> dict[str, float]:
        """Each leaf's norm of the first gradient as the optimizer took it:
        its first moment after one step, over 1 - b1."""
        names = list(state.opt.mu)
        norms = torch.stack([state.opt.mu[n].norm() for n in names]) / (1 - self.b1)
        return dict(zip(names, norms.tolist()))

    @torch.no_grad()
    def snapshot(self) -> list[torch.Tensor]:
        return [p.detach().clone() for p in self.module.parameters()]

    @torch.no_grad()
    def change(self, start: list[torch.Tensor]) -> dict[str, float]:
        """Each leaf's norm of its change since `start` (`snapshot`)."""
        names, norms = [], []
        for (name, p), p0 in zip(self.module.named_parameters(), start):
            names.append(name)
            norms.append((p.float() - p0.float()).norm())
        return dict(zip(names, torch.stack(norms).tolist()))
