"""Train / prefill / serve step builders on a (mesh, plan).

`build_*` take the model, a `DeviceMesh` (`launch.mesh`) and a
`ShardingPlan`, and return ``(step, shardings)``: the step function,
built once and called every step, and where its state lives (the
parameters', and for training the AdamW moments', `Sharding` per name).

On a mesh of one device the step is the plain one: loss and gradients
(with optional microbatch accumulation), the global-norm clip and AdamW,
all queued on the parameters' device with no read-back to the host; the
forward pass; one decode token against the caches.  No DTensor and no
process group: every placement on one device is ``Replicate()``.

On a mesh of more than one device (`shard_train_state`, `shard_params`
place the state) every parameter is a DTensor with the plan's
placements, every moment one with its ZeRO-1 placement (`zero1`: the
first dim that ``data`` divides), and a batch leaf is split over the
plan's batch axes (``Shard(0)``, or ``Shard(1)`` of [accum, micro, ...]).
The step gathers the weights at use, as GSPMD gathers a weight stored
sharded; each rank computes the loss of its own batch shard weighted by
its share of the global batch's supervised tokens (labels of -1 are
ignored, so a mean of per-rank means is not the global mean), and the
MoE load-balance term, a mean over dispatch groups, by its share of the
groups (each rank must hold a whole number of them); the
gradients are summed over the batch axes, so the global-norm clip sees
all of them; the AdamW update runs on each moment's shard and the new
weights go back to the plan's placements.  The tensor-parallel and
sequence-parallel compute of the reference's plans (Megatron column and
row products, the sharded KV cache in decode) is held by placement only:
the values are the one-device step's, computed on gathered weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from ..distributed.sharding import (
    Sharding,
    ShardingPlan,
    axis_size,
    batch_sharding,
    cache_sharding,
    ssm_cache_sharding,
    tree_shardings,
)
from ..models.model_zoo import Model
from ..models.transformer import decay_mask
from ..optim.adamw import AdamWConfig, OptState, apply_updates, global_norm, init_opt

__all__ = [
    "StateShardings",
    "TrainState",
    "batch_shardings_for",
    "build_prefill_step",
    "build_serve_step",
    "build_train_step",
    "cache_shardings_for",
    "init_train_state",
    "param_specs",
    "shard_params",
    "shard_train_state",
]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer
    state and the step count (an int32 tensor on the device)."""

    params: nn.Module
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


@dataclasses.dataclass(frozen=True)
class StateShardings:
    """Where a train state lives: each parameter's and each moment's
    `Sharding` (mu and nu alike), by parameter name."""

    params: dict[str, Sharding]
    moments: dict[str, Sharding]


def init_train_state(
    model: Model, generator: torch.Generator | None = None, device="cuda"
) -> TrainState:
    module = model.init(generator=generator, device=device)
    return TrainState(
        params=module,
        opt=init_opt(dict(module.named_parameters())),
        step=torch.zeros((), dtype=torch.int32, device=module.embed.device),
    )


def param_specs(model: Model) -> dict[str, torch.Tensor]:
    """The parameters' shapes and dtypes as meta tensors, by name (no
    weights are drawn)."""
    with torch.device("meta"):
        module = model.init(device="meta")
    return {n: p.detach() for n, p in module.named_parameters()}


def _param_shardings(model: Model, mesh: DeviceMesh, plan: ShardingPlan):
    specs = param_specs(model)
    return tree_shardings(mesh, model.param_axes(), plan, specs), specs


def _zero1(sh: Sharding, shape, dsize: int) -> Sharding:
    """A moment's sharding under ZeRO-1: the parameter's, with ``data``
    on the first dim it leaves unsharded that ``data`` divides."""
    dims = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
    used = {a for dim in dims for a in ((dim,) if isinstance(dim, str) else (dim or ()))}
    if "data" in used:
        return sh
    for i, (dim, size) in enumerate(zip(dims, shape)):
        if dim is None and size % dsize == 0 and size >= dsize:
            dims[i] = "data"
            return Sharding(sh.mesh, tuple(dims))
    return sh


def batch_shardings_for(model: Model, mesh: DeviceMesh, plan: ShardingPlan,
                        specs: dict) -> dict[str, Sharding]:
    return {name: batch_sharding(mesh, len(spec.shape), plan)
            for name, spec in specs.items()}


_ATTN_CACHE_KEYS = {"k", "v", "cross_k", "cross_v"}


def cache_shardings_for(mesh: DeviceMesh, plan: ShardingPlan, cache_specs: dict,
                        seq_dim: int = 2) -> dict[str, Sharding]:
    """Attention caches [L,B,S,KV,D] shard batch and cache sequence; SSM
    state and conv-tail caches [L,B,...] shard batch only (told apart by
    key name: the conv tail is 4-D but its dim 2 is the conv window, not
    sequence).  A dim its mesh axes do not divide is replicated (the
    sliding window's ring buffer drops cache-sequence sharding)."""
    out = {}
    for key, s in cache_specs.items():
        if key in _ATTN_CACHE_KEYS:
            sh = cache_sharding(mesh, s.shape, plan, seq_dim=seq_dim)
        else:
            sh = ssm_cache_sharding(mesh, s.shape, plan)
        out[key] = sh.sanitized(s.shape)
    return out


# -- placing state on a mesh of more than one device --------------------------


def _distribute(t: torch.Tensor, sh: Sharding) -> DTensor:
    return distribute_tensor(t.detach(), sh.mesh, sh.placements)


@torch.no_grad()
def shard_params(module: nn.Module, param_sh: dict[str, Sharding]) -> nn.Module:
    """Each parameter of `module` (the same weights on every rank) as a
    DTensor with its placements, in place; on a one-device mesh the
    module is left as it is."""
    for name, p in list(module.named_parameters()):
        sh = param_sh[name]
        if sh.mesh.size() == 1:
            return module
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, nn.Parameter(_distribute(p, sh)))
    return module


def shard_train_state(state: TrainState, state_sh: StateShardings) -> TrainState:
    """`state` on its mesh: the parameters and the moments as DTensors (a
    one-device mesh leaves it as it is)."""
    shard_params(state.params, state_sh.params)
    if all(sh.mesh.size() == 1 for sh in state_sh.moments.values()):
        return state
    place = lambda d: {n: _distribute(t, state_sh.moments[n]) for n, t in d.items()}
    state.opt = state.opt._replace(mu=place(state.opt.mu), nu=place(state.opt.nu))
    return state


# -- the step on a mesh of more than one device --------------------------------


class _Gathered:
    """A plain replica of the model on this rank's device whose weights
    are the DTensors' full values, refreshed at every call (the
    all-gather GSPMD inserts where a sharded weight is used).  Its meta
    module is made when the step is built: `to_empty` cannot move a
    module made under `FakeTensorMode` (the dry run's) onto a device."""

    def __init__(self, model: Model):
        with torch.device("meta"):
            self.meta = model.init(device="meta")
        self.module = None

    @torch.no_grad()
    def __call__(self, params: nn.Module) -> nn.Module:
        full = {n: p.full_tensor() for n, p in params.named_parameters()}
        if self.module is None:
            self.module = self.meta.to_empty(device=next(iter(full.values())).device)
        for n, p in self.module.named_parameters():
            p.copy_(full[n])
        return self.module


def _batch_layout(mesh: DeviceMesh, plan: ShardingPlan, dim: int):
    """(the batch leaves' placements with the batch at tensor dim `dim`,
    the placements of a per-rank partial sum over the batch axes)."""
    batch = batch_sharding(mesh, 1, plan).placements
    leaves = tuple(Shard(dim) if isinstance(p, Shard) else p for p in batch)
    partial = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in batch)
    return leaves, partial


def _local_batch(batch: dict, mesh: DeviceMesh, placements) -> dict:
    """This rank's shard of each batch leaf (a plain tensor is the global
    batch, the same on every rank)."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, DTensor):
            v = distribute_tensor(v, mesh, placements)
        out[k] = v.redistribute(mesh, placements).to_local()
    return out


def _sum_over_batch(x: torch.Tensor, mesh: DeviceMesh, partial) -> torch.Tensor:
    return DTensor.from_local(x, mesh, partial).full_tensor()


def _reshard(full: torch.Tensor, mesh: DeviceMesh, sh: Sharding) -> torch.Tensor:
    """This rank's shard, under `sh`, of a tensor whole on every rank."""
    return DTensor.from_local(full, mesh, (Replicate(),) * mesh.ndim).redistribute(
        mesh, sh.placements).to_local()


def _group_share(cfg, mb: dict, shards: int) -> float:
    """This rank's share of a microbatch's MoE dispatch groups (1/shards).

    The reference groups the global token array; the ranks' groups are
    those groups only where each rank holds a whole number of them.
    """
    tokens = mb["tokens"].shape[0] * (
        mb["tokens"].shape[1]
        + (mb["frontend_embeds"].shape[1] if "frontend_embeds" in mb else 0))
    group = min(cfg.moe_group, tokens * shards)
    if shards > 1 and tokens % group:
        raise ValueError(
            f"the moe step over {shards} batch shards needs each rank's tokens "
            f"({tokens}) to be a whole number of dispatch groups of {group}"
        )
    return 1.0 / shards


def _sharded_train_step(model, mesh, plan, opt_cfg, state_sh, accum_steps, triangular):
    replica = _Gathered(model)
    leaves, partial = _batch_layout(mesh, plan, 1 if accum_steps > 1 else 0)
    shards = 1
    for i, p in enumerate(leaves):
        shards *= mesh.size(i) if isinstance(p, Shard) else 1

    def train_step(state: TrainState, batch: dict):
        module = replica(state.params)
        weights = list(module.parameters())
        local = _local_batch(batch, mesh, leaves)
        micro = ([{k: v[i] for k, v in local.items()} for i in range(accum_steps)]
                 if accum_steps > 1 else [local])
        loss = torch.zeros((), dtype=torch.float32, device=weights[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in weights]
        for mb in micro:
            # this shard's share of the global means: over supervised
            # tokens for the cross-entropy, over dispatch groups for the
            # MoE aux
            count = (mb["labels"] >= 0).sum().to(torch.float32)
            share = count / _sum_over_batch(count, mesh, partial).clamp_min(1)
            ce, aux = model.loss_parts(module, mb, triangular=triangular)
            part = ce * share
            if model.cfg.family == "moe" and model.cfg.n_experts:
                part = part + aux * _group_share(model.cfg, mb, shards)
            loss = loss + part.detach()
            grads = [a + g for a, g in zip(grads, torch.autograd.grad(part, weights))]
        loss = _sum_over_batch(loss, mesh, partial) / accum_steps
        names = [n for n, _ in module.named_parameters()]
        full = {n: _sum_over_batch(g / accum_steps, mesh, partial)
                for n, g in zip(names, grads)}
        gnorm = global_norm(full)
        params = dict(state.params.named_parameters())
        with torch.no_grad():  # each moment's shard of the weights and gradients
            shard = {n: _reshard(t.detach(), mesh, state_sh.moments[n])
                     for n, t in module.named_parameters()}
            grad_shard = {n: _reshard(g, mesh, state_sh.moments[n])
                          for n, g in full.items()}
        local_opt = OptState({n: m.to_local() for n, m in state.opt.mu.items()},
                             {n: v.to_local() for n, v in state.opt.nu.items()},
                             state.opt.count)
        _, opt, om = apply_updates(opt_cfg, shard, grad_shard, local_opt,
                                   decay_mask(state.params), grad_norm=gnorm)
        with torch.no_grad():
            for n, p in params.items():
                new = DTensor.from_local(shard[n], mesh, state_sh.moments[n].placements)
                p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())
        opt = state.opt._replace(count=opt.count)
        metrics = {"loss": loss, **om}
        return TrainState(params=state.params, opt=opt, step=state.step + 1), metrics

    return train_step


# -- the builders ---------------------------------------------------------------


def build_train_step(
    model: Model,
    mesh: DeviceMesh,
    plan: ShardingPlan,
    opt_cfg: AdamWConfig | None = None,
    *,
    accum_steps: int = 1,
    triangular: bool = False,
    zero1: bool = True,
):
    """Fused train step: grads -> clip -> AdamW, optional microbatch accum.

    Returns ``(train_step, state_sh)``: ``train_step(state, batch) ->
    (state, metrics)`` with `metrics` device tensors (``loss``,
    ``grad_norm``, ``lr``), and the `StateShardings` that
    `shard_train_state` places a state by.  With ``accum_steps > 1`` each
    batch leaf is [accum, micro, ...] and the gradients are summed in f32
    over the microbatches, then averaged.  ``zero1`` shards the AdamW
    moments over ``data`` (ZeRO-1).
    """
    opt_cfg = opt_cfg or AdamWConfig()
    param_sh, specs = _param_shardings(model, mesh, plan)
    moments = param_sh
    if zero1 and "data" in (mesh.mesh_dim_names or ()):
        dsize = axis_size(mesh, "data")
        moments = {n: _zero1(sh, specs[n].shape, dsize) for n, sh in param_sh.items()}
    state_sh = StateShardings(params=param_sh, moments=moments)
    if mesh.size() > 1:
        return _sharded_train_step(model, mesh, plan, opt_cfg, state_sh,
                                   accum_steps, triangular), state_sh

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

    return train_step, state_sh


def build_prefill_step(model: Model, mesh: DeviceMesh, plan: ShardingPlan, *,
                       triangular: bool = False):
    """``(prefill, param_sh)``: ``prefill(module, batch) -> logits`` (the
    full-sequence forward).  On a mesh of more than one device the logits
    are a DTensor split over the batch axes, as the batch."""
    param_sh, _ = _param_shardings(model, mesh, plan)
    if mesh.size() == 1:
        @torch.inference_mode()
        def prefill(module: nn.Module, batch: dict):
            return model.forward(module, batch, triangular=triangular)

        return prefill, param_sh

    replica = _Gathered(model)
    leaves, _ = _batch_layout(mesh, plan, 0)

    @torch.inference_mode()
    def sharded_prefill(module: nn.Module, batch: dict):
        logits = model.forward(replica(module), _local_batch(batch, mesh, leaves),
                               triangular=triangular)
        return DTensor.from_local(logits, mesh, leaves)

    return sharded_prefill, param_sh


def build_serve_step(model: Model, mesh: DeviceMesh, plan: ShardingPlan, seq_len: int):
    """``(serve, param_sh)``: ``serve(module, caches, tokens, index) ->
    (logits, caches)``, one decode token at the absolute position `index`
    (a Python int); the caches are written in place.  On a mesh of more
    than one device the caches are DTensors placed by
    `cache_shardings_for`: the step gathers them with the weights,
    decodes the whole batch and writes each rank's shard back."""
    param_sh, _ = _param_shardings(model, mesh, plan)
    if mesh.size() == 1:
        def serve(module: nn.Module, caches: dict, tokens: torch.Tensor, index: int):
            return model.decode_step(module, caches, tokens, index, seq_len)

        return serve, param_sh

    replica = _Gathered(model)
    replicated = (Replicate(),) * mesh.ndim

    def sharded_serve(module: nn.Module, caches: dict, tokens, index: int):
        full = {k: c.full_tensor() for k, c in caches.items()}
        if isinstance(tokens, DTensor):
            tokens = tokens.full_tensor()
        logits, full = model.decode_step(replica(module), full, tokens, index, seq_len)
        with torch.no_grad():
            for k, c in caches.items():
                new = DTensor.from_local(full[k], mesh, replicated)
                c.to_local().copy_(new.redistribute(mesh, c.placements).to_local())
        return DTensor.from_local(logits, mesh, replicated), caches

    return sharded_serve, param_sh
