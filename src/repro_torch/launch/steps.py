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
placements, every moment one with its ZeRO-1 placement (`_zero1`: the
first dim that ``data`` divides; a per-layer leaf with no such dim keeps
its moments stacked over the layers, [L, ...] split over ``data``, where
``data`` divides L, as the reference's stacked leaf), and a batch leaf
is split over the plan's batch axes (``Shard(0)``, or ``Shard(1)`` of
[accum, micro, ...]).

The train and prefill steps hand the model each weight as this rank's
storage shard and compute it as `sharding.compute_placements` says: a
weight stored split over a batch axis (FSDP; the experts' hidden dim
over ``data``) is gathered at use, per layer, as GSPMD gathers a weight
stored sharded: the layer that reads it all-gathers it over those axes
and reduce-scatters its gradient over them
(`distributed.tensor_parallel.gathered`; inside a remat layer the copy
lives while the layer computes, and the recompute gathers it again); a
weight split over the model axis stays this rank's shard, and the model
computes on it (`distributed.tensor_parallel`: Megatron column and row
products, vocab-parallel embedding, logits and cross-entropy,
expert-parallel MoE).  Each rank computes the loss of its own batch
shard weighted by its share of the global batch's supervised tokens
(labels of -1 are ignored, so a mean of per-rank means is not the
global mean), and the MoE load-balance term, a mean over the global
array's dispatch groups, by its share of the batch (where a rank's
tokens are no whole number of groups, the MoE block gathers its input
over the batch axes and routes the global groups, `models.moe`).  A
gradient stays on its shard: summed over the microbatches in f32 in its
weight's storage-shard shape, then over the remaining batch axes into
its moment's shard (a reduce-scatter); the global-norm clip adds each
shard's square-sum once over the axes it is split on; the AdamW update
runs on each moment's shard and the new weights go back to the plan's
placements.  The prefill returns its logits as a DTensor, batch over
the batch axes and, where the vocab is split, vocab over the model axis.

The serve step decodes each rank's batch shard against its own slices
of the caches (`DECODE_PLAN`: the KV caches' sequence over ``model``,
the SSM's caches over the batch only) on its own shards of the weights,
the experts' hidden dim over ``data`` included
(`sharding.SERVE_SHARDED_ON_BATCH`): no cache and no weight is gathered.
The attention's softmax is combined over ``model``, the caches are
written in place on the rank that holds the position, and the logits
come back as the prefill's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from ..distributed.sharding import (
    SERVE_SHARDED_ON_BATCH,
    Sharding,
    ShardingPlan,
    axis_size,
    batch_sharding,
    cache_sharding,
    compute_placements,
    ssm_cache_sharding,
    tensor_parallel,
    tree_shardings,
)
from ..models.model_zoo import Model
from ..models.transformer import LAYER_STACKS, decay_mask
from ..optim.adamw import AdamWConfig, OptState, apply_updates, init_opt
from ..telemetry import regions

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
    """Where a train state lives: each parameter's `Sharding` by name;
    each moment's (mu and nu alike) by the name of its entry in the
    optimizer state: a parameter's, or a stack's key (``layers.ssm.A_log``,
    the reference's name of the stacked leaf) whose moments hold the
    per-layer parameters `stacks` names, in layer order, as one [L, ...]
    tensor."""

    params: dict[str, Sharding]
    moments: dict[str, Sharding]
    stacks: dict[str, tuple[str, ...]] = dataclasses.field(default_factory=dict)


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


def _zero1_moments(model: Model, param_sh: dict, specs: dict, dsize: int):
    """(each optimizer-state entry's sharding, the stacks): `_zero1` on
    every parameter, except a per-layer leaf that takes no ``data`` on
    its own dims where ``data`` divides the layer count: its moments are
    stacked [L, ...] with ``data`` on the layer dim, as the reference's
    ZeRO-1 shards its stacked leaf (only under ``scan_layers``)."""
    moments = {n: _zero1(sh, specs[n].shape, dsize) for n, sh in param_sh.items()}
    stacks: dict[str, list[str]] = {}
    if model.cfg.scan_layers and dsize > 1:
        for name in param_sh:
            head, *rest = name.split(".")
            if head in LAYER_STACKS:
                stacks.setdefault(".".join([head] + rest[1:]), []).append(name)
    out = {}
    for key, names in stacks.items():
        sh = param_sh[names[0]]
        if (len(names) % dsize or moments[names[0]] is not sh
                or "data" in _used_axes(sh.spec)):
            continue
        spec = ("data",) + tuple(sh.spec) + (None,) * (specs[names[0]].dim() - len(sh.spec))
        for n in names:
            del moments[n]
        moments[key] = Sharding(sh.mesh, spec)
        out[key] = tuple(names)
    return moments, out


def _used_axes(spec) -> set:
    return {a for dim in spec for a in ((dim,) if isinstance(dim, str) else (dim or ()))}


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
    """`state` on its mesh: the parameters and the moments as DTensors,
    the moments of each of `state_sh.stacks` stacked [L, ...] under its
    key (a one-device mesh leaves it as it is)."""
    shard_params(state.params, state_sh.params)
    if all(sh.mesh.size() == 1 for sh in state_sh.moments.values()):
        return state

    def place(d):
        d = dict(d)
        for key, names in state_sh.stacks.items():
            d[key] = torch.stack([d.pop(n) for n in names])
        return {n: _distribute(t, state_sh.moments[n]) for n, t in d.items()}

    state.opt = state.opt._replace(mu=place(state.opt.mu), nu=place(state.opt.nu))
    return state


# -- the step on a mesh of more than one device --------------------------------


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


def _shifted(placements) -> tuple:
    """Placements of a tensor stacked on a new leading dim."""
    return tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p for p in placements)


class _Local:
    """The model to compute a sharded step with: a replica (its meta
    module made when the step is built) whose parameters are, at each
    call, this rank's storage shards, and the step's `TensorParallel`
    context bound to them.  A shard split over the model axis is
    computed on as it is; one split over batch axes that
    `compute_placements` computes whole (but for the logical axes in
    `keep`) is the context's ``stored``: the layer that reads it gathers
    it there (`tensor_parallel.gathered`), so no weight is gathered
    before the step and none outlives its layer."""

    def __init__(self, model: Model, param_sh: dict, plan: ShardingPlan,
                 keep: frozenset = frozenset()):
        with torch.device("meta"):
            self.meta = model.init(device="meta")
        self.tp = tensor_parallel(param_sh, plan, model.param_axes(), keep)
        self.placements = {n: sh.placements for n, sh in param_sh.items()}
        self.slots = {n: n.rpartition(".") for n in param_sh}

    @torch.no_grad()
    def __call__(self, params: nn.Module, requires_grad: bool):
        """(the module, its tensors by name, the bound context or None);
        a parameter placed otherwise than `param_sh` says is moved there."""
        local = {}
        for n, p in params.named_parameters():
            t = p.redistribute(p.device_mesh, self.placements[n]).to_local()
            t = t.detach().requires_grad_(requires_grad)
            owner, _, leaf = self.slots[n]
            self.meta.get_submodule(owner)._parameters[leaf] = local[n] = t
        return self.meta, local, self.tp.bind(local)


def _grad_norm(grads: dict, moments: dict, mesh: DeviceMesh) -> torch.Tensor:
    """The global norm of gradients held as their moments' shards: each
    shard's square-sum, summed over the mesh axes its moment is split on
    (once over each, whatever the replicas)."""
    sums: dict[tuple, torch.Tensor] = {}
    for n, g in grads.items():
        axes = tuple(i for i, p in enumerate(moments[n].placements) if isinstance(p, Shard))
        part = torch.sum(torch.square(g.float()))
        sums[axes] = sums[axes] + part if axes in sums else part
    total = []
    for axes, part in sums.items():
        for i in axes:
            pl = tuple(Partial() if j == i else Replicate() for j in range(mesh.ndim))
            part = DTensor.from_local(part, mesh, pl).full_tensor()
        total.append(part)
    return torch.sqrt(torch.sum(torch.stack(total)))


def _sharded_train_step(model, mesh, plan, opt_cfg, state_sh, accum_steps, triangular):
    local_model = _Local(model, state_sh.params, plan)
    leaves, partial = _batch_layout(mesh, plan, 1 if accum_steps > 1 else 0)
    shards = 1
    for i, p in enumerate(leaves):
        shards *= mesh.size(i) if isinstance(p, Shard) else 1
    stacked = {n for names in state_sh.stacks.values() for n in names}

    def summed(name):
        """A gradient's placements: its weight's, reduce-scattered over the
        batch axes the weight is stored split on (`tensor_parallel.gathered`
        did that), a partial sum over the other batch axes."""
        return tuple(q if isinstance(q, Partial) and not isinstance(p, Shard) else p
                     for p, q in zip(state_sh.params[name].placements, partial))

    def to_moments(tensors: dict, placements) -> dict:
        """Each tensor (this rank's under `placements(name)`) as its
        moment entry's shard; a stack's layers stacked first."""
        out = {n: DTensor.from_local(t, mesh, placements(n)).redistribute(
            mesh, state_sh.moments[n].placements).to_local()
            for n, t in tensors.items() if n not in stacked}
        for key, names in state_sh.stacks.items():
            t = torch.stack([tensors[n] for n in names])
            out[key] = DTensor.from_local(t, mesh, _shifted(placements(names[0]))).redistribute(
                mesh, state_sh.moments[key].placements).to_local()
        return out

    def train_step(state: TrainState, batch: dict):
        module, weights, tp = local_model(state.params, True)
        names = list(weights)
        local = _local_batch(batch, mesh, leaves)
        micro = ([{k: v[i] for k, v in local.items()} for i in range(accum_steps)]
                 if accum_steps > 1 else [local])
        loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
        # f32 sums in each weight's storage-shard shape
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in weights.values()]
        for mb in micro:
            # this shard's share of the global means: over supervised
            # tokens for the cross-entropy, over dispatch groups for the
            # MoE aux
            count = (mb["labels"] >= 0).sum().to(torch.float32)
            share = count / _sum_over_batch(count, mesh, partial).clamp_min(1)
            ce, aux = model.loss_parts(module, mb, triangular=triangular, tp=tp)
            part = ce * share
            if model.cfg.family == "moe" and model.cfg.n_experts:
                # every rank's aux is the global groups' mean (`models.moe`)
                part = part + aux / shards
            loss = loss + part.detach()
            grads = [a + g for a, g in zip(
                grads, torch.autograd.grad(part, list(weights.values())))]
        loss = _sum_over_batch(loss, mesh, partial) / accum_steps
        params = dict(state.params.named_parameters())
        with torch.no_grad():  # each moment's shard of the weights and gradients
            grad_shard = to_moments(
                {n: g / accum_steps for n, g in zip(names, grads)}, summed)
            shard = to_moments({n: p.to_local() for n, p in params.items()},
                               lambda n: params[n].placements)
        with regions.region("optimizer"):  # the clip norm and AdamW
            gnorm = _grad_norm(grad_shard, state_sh.moments, mesh)
            local_opt = OptState({n: m.to_local() for n, m in state.opt.mu.items()},
                                 {n: v.to_local() for n, v in state.opt.nu.items()},
                                 state.opt.count)
            decay = decay_mask(state.params)
            decay.update({key: decay[layers[0]] for key, layers in state_sh.stacks.items()})
            _, opt, om = apply_updates(opt_cfg, shard, grad_shard, local_opt,
                                       decay, grad_norm=gnorm)
        with torch.no_grad():  # the new weights back to the plan's placements
            for n, t in shard.items():
                new = DTensor.from_local(t, mesh, state_sh.moments[n].placements)
                layers = state_sh.stacks.get(n)
                if layers is None:
                    params[n].to_local().copy_(
                        new.redistribute(mesh, params[n].placements).to_local())
                    continue
                new = new.redistribute(mesh, _shifted(params[layers[0]].placements))
                for layer, value in zip(layers, new.to_local()):
                    params[layer].to_local().copy_(value)
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
    moments, stacks = param_sh, {}
    if zero1 and "data" in (mesh.mesh_dim_names or ()):
        moments, stacks = _zero1_moments(model, param_sh, specs, axis_size(mesh, "data"))
    state_sh = StateShardings(params=param_sh, moments=moments, stacks=stacks)
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
        with regions.region("optimizer"):
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
    are a DTensor split over the batch axes, as the batch, and over the
    model axis on the vocab where the plan splits the vocab there."""
    param_sh, _ = _param_shardings(model, mesh, plan)
    if mesh.size() == 1:
        @torch.inference_mode()
        def prefill(module: nn.Module, batch: dict):
            return model.forward(module, batch, triangular=triangular)

        return prefill, param_sh

    local_model = _Local(model, param_sh, plan)
    leaves, _ = _batch_layout(mesh, plan, 0)
    vocab = compute_placements(param_sh["embed"], plan)

    # no_grad, not inference_mode: a DTensor's redistribute there calls
    # `aten.detach_`, which some torch releases give no sharding strategy
    @torch.no_grad()
    def sharded_prefill(module: nn.Module, batch: dict):
        local, _, tp = local_model(module, False)
        logits = model.forward(local, _local_batch(batch, mesh, leaves),
                               triangular=triangular, tp=tp)
        out = tuple(Shard(2) if isinstance(v, Shard) else b for b, v in zip(leaves, vocab))
        return DTensor.from_local(logits, mesh, out)

    return sharded_prefill, param_sh


def _split_caches(caches: dict, tp, mesh: DeviceMesh) -> frozenset:
    """The caches whose sequence is split over the context's model axis
    (their placement there is a ``Shard``: the attention caches are
    split over it on their sequence only)."""
    if tp.size == 1:
        return frozenset()
    names = mesh.mesh_dim_names or ()
    at = next(i for i, a in enumerate(names) if mesh.get_group(a).group_name == tp.group)
    return frozenset(k for k, c in caches.items() if isinstance(c.placements[at], Shard))


def build_serve_step(model: Model, mesh: DeviceMesh, plan: ShardingPlan, seq_len: int):
    """``(serve, param_sh)``: ``serve(module, caches, tokens, index) ->
    (logits, caches)``, one decode token at the absolute position `index`
    (a Python int); the caches are written in place.  On a mesh of more
    than one device the caches are DTensors placed by
    `cache_shardings_for` and the tokens the global batch (a tensor, or
    a DTensor over the batch axes): each rank decodes its batch rows
    against its slices of the caches, on its shards of the weights, and
    the logits are a DTensor as the prefill's."""
    param_sh, _ = _param_shardings(model, mesh, plan)
    if mesh.size() == 1:
        def serve(module: nn.Module, caches: dict, tokens: torch.Tensor, index: int):
            return model.decode_step(module, caches, tokens, index, seq_len)

        return serve, param_sh

    local_model = _Local(model, param_sh, plan, SERVE_SHARDED_ON_BATCH)
    leaves, _ = _batch_layout(mesh, plan, 0)
    vocab = compute_placements(param_sh["embed"], plan)
    out = tuple(Shard(2) if isinstance(v, Shard) else b for b, v in zip(leaves, vocab))

    def sharded_serve(module: nn.Module, caches: dict, tokens, index: int):
        local, _, tp = local_model(module, False)
        tp = dataclasses.replace(tp, caches=_split_caches(caches, tp, mesh))
        rows = _local_batch({"tokens": tokens}, mesh, leaves)["tokens"]
        logits, _ = model.decode_step(local, {k: c.to_local() for k, c in caches.items()},
                                      rows, index, seq_len, tp)
        return DTensor.from_local(logits, mesh, out), caches

    return sharded_serve, param_sh
