"""Logical-axis sharding rules (MaxText-style) -> DTensor placements.

Every parameter declares logical axes (`models.*_axes`, `Model.param_axes`);
a `ShardingPlan` maps logical names to the axes of a named
`torch.distributed.device_mesh.DeviceMesh`.  Conflicts (two logical axes
of one tensor mapping to the same mesh axis) are resolved
first-come-first-served along the dims, so e.g. MoE weights (expert,
embed, mlp) with expert->model and mlp->model shard over experts and
leave mlp replicated — expert parallelism wins on expert tensors.

Each rule gives a `Sharding`: the spec (one entry per tensor dim: None,
a mesh axis name, or a tuple of names, as the reference's
``PartitionSpec``) and the DTensor placements it means (one entry per
mesh dim: ``Shard(d)`` or ``Replicate()``).  A tensor dim split over
several mesh axes is split major-first in the mesh's dim order, which is
what a DTensor's placements express; a spec that names them in another
order raises rather than place the tensor wrongly.

Plans are data, not code: the four plans are the reference's, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .tensor_parallel import MeshAxis, TensorParallel

__all__ = [
    "ShardingPlan",
    "Sharding",
    "axis_size",
    "BASELINE_PLAN",
    "DECODE_PLAN",
    "DP_ALL_PLAN",
    "DP_FSDP_PLAN",
    "spec_for_axes",
    "sharding_for_axes",
    "tree_shardings",
    "batch_sharding",
    "cache_sharding",
    "ssm_cache_sharding",
    "shard_placements",
    "compute_placements",
    "SERVE_SHARDED_ON_BATCH",
    "tensor_parallel",
]

MeshAxes = tuple[str, ...] | str | None


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """logical axis name -> mesh axis (or axes tuple, or None=replicate)."""

    name: str
    rules: Mapping[str, MeshAxes]
    #: mesh axes carrying the batch dimension of activations.
    batch_axes: tuple[str, ...] = ("pod", "data")
    #: mesh axes carrying the sequence dim of activations ("" = unsharded).
    seq_axes: tuple[str, ...] = ()
    #: mesh axes for the KV-cache sequence dim in decode.
    cache_seq_axes: tuple[str, ...] = ("model",)

    def lookup(self, logical: str | None) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)


#: Baseline plan: textbook Megatron TP over `model` (column-parallel wi /
#: wq-k-v, row-parallel wo/wd), vocab-parallel embedding, DP over data
#: (and pods), experts expert-parallel over `model` with their hidden dim
#: 2D-sharded over `data`.  Weights are deliberately NOT sharded on
#: contraction dims over `data`.
BASELINE_PLAN = ShardingPlan(
    name="tp16-dp16",
    rules={
        "vocab": "model",
        "embed": None,
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "expert": "model",
        "expert_mlp": "data",
        "layer": None,
    },
)

#: Decode-oriented plan: weights replicated over `data`, TP over model,
#: KV-cache sequence sharded over `model` (sequence-parallel attention).
DECODE_PLAN = ShardingPlan(
    name="decode-tp16",
    rules={
        "vocab": "model",
        "embed": None,
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "expert": "model",
        "expert_mlp": "data",
        "layer": None,
    },
)

#: Pure data parallelism over the whole mesh: every weight replicated,
#: batch sharded over all axes.
DP_ALL_PLAN = ShardingPlan(
    name="dp256",
    rules={"layer": None},
    batch_axes=("pod", "data", "model"),
)

#: Weight-gather FSDP: batch over ALL mesh axes, weights STORED sharded
#: over `model`, gathered at use, their gradients reduce-scattered.
DP_FSDP_PLAN = ShardingPlan(
    name="dp-fsdp16",
    rules=dict(BASELINE_PLAN.rules),
    batch_axes=("pod", "data", "model"),
)


def _names(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of the mesh axis named `axis`."""
    return mesh.size(_names(mesh).index(axis))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on `mesh`: `spec` has one entry per tensor
    dim (None, a mesh axis name or a tuple of names)."""

    mesh: DeviceMesh
    spec: tuple[MeshAxes, ...]

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` where tensor
        dim d is split over it, else ``Replicate()`` (so on a dim of size
        1, where both mean one whole copy)."""
        names = _names(self.mesh)
        out: list = [Replicate()] * len(names)
        for d, axes in enumerate(self.spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            at = [names.index(a) for a in axes]
            if at != sorted(at):
                raise ValueError(
                    f"dim {d} is split over {axes}, not in the mesh's dim order "
                    f"{names}: DTensor placements cannot express it"
                )
            for i in at:
                if self.mesh.size(i) > 1:
                    out[i] = Shard(d)
        return tuple(out)

    def sanitized(self, shape: Sequence[int]) -> "Sharding":
        """The same spec padded with None to len(shape), each dim whose
        size its mesh axes' product does not divide replicated."""
        dims = list(self.spec) + [None] * (len(shape) - len(self.spec))
        for i, (dim, size) in enumerate(zip(dims, shape)):
            if dim is None:
                continue
            prod = 1
            for a in (dim,) if isinstance(dim, str) else dim:
                prod *= axis_size(self.mesh, a)
            if size % prod != 0:
                dims[i] = None
        return Sharding(self.mesh, tuple(dims))


#: The serve step's exception to the storage rule of `compute_placements`:
#: the logical axes a serve step computes on the rank's shard where the
#: plan splits them over a batch axis.  The experts' hidden dim
#: (``expert_mlp`` over ``data``): decode has few tokens and large
#: weights, so the MoE block gathers its tokens over the batch axes
#: (B x d_model a layer) and reduces a partial sum over ``data``, where
#: gathering the weights would move every expert's whole hidden dim on
#: every token.
SERVE_SHARDED_ON_BATCH = frozenset({"expert_mlp"})


def compute_placements(sh: Sharding, plan: ShardingPlan,
                       logical: Sequence[str | None] = (),
                       keep: frozenset = frozenset()) -> tuple:
    """The placements a step computes a parameter with.

    A split over an axis of the plan's ``batch_axes`` is storage (FSDP,
    `DP_FSDP_PLAN`'s ``model``, `BASELINE_PLAN`'s ``expert_mlp`` over
    ``data``): the weight is computed whole, ``Replicate()``, gathered by
    the layer that uses it (`tensor_parallel.gathered`), unless the
    split dim's logical axis (`logical`, one per dim) is in `keep`
    (`SERVE_SHARDED_ON_BATCH` in a serve step).  A split over any other
    axis is tensor or expert parallelism (`BASELINE_PLAN`'s heads,
    kv_heads, mlp, vocab and expert over ``model``): the rank computes on
    its shard, the placement stays.  A dim that sanitisation left whole
    is computed whole.
    """
    names = _names(sh.mesh)
    logical = tuple(logical) + (None,) * len(sh.spec)
    return tuple(Replicate() if names[i] in plan.batch_axes
                 and not (isinstance(p, Shard) and logical[p.dim] in keep) else p
                 for i, p in enumerate(sh.placements))


def tensor_parallel(shardings: Mapping[str, Sharding], plan: ShardingPlan,
                    axes: Mapping[str, Sequence[str | None]] | None = None,
                    keep: frozenset = frozenset()):
    """The `TensorParallel` context of a step over these parameter
    shardings (`axes`, `keep`: `compute_placements`' arguments, by
    parameter name), or None on a mesh of one device.  Its ``dims`` are
    the dims `compute_placements` leaves split over a model axis, and
    its ``batch_dims`` those it leaves split over batch axes, its
    ``stored`` those it gathers over batch axes (the weight is handed
    over as its storage shard and gathered where it is used); its
    ``batch`` the plan's batch axes of more than one rank.  One mesh axis
    at most may carry model splits; the context is over that axis, else
    over the plan's cache-sequence axis where the mesh has one, else of
    one rank (no group)."""
    dims: dict[str, int] = {}
    batch_dims: dict[str, tuple[int, tuple[int, ...]]] = {}
    stored: dict[str, tuple[tuple[int, int], ...]] = {}
    found: set[int] = set()
    mesh = next(iter(shardings.values())).mesh
    if mesh.size() == 1:
        return None
    names = _names(mesh)
    batch_names = [a for a in names if a in plan.batch_axes and axis_size(mesh, a) > 1]
    batch = tuple(MeshAxis(mesh.get_group(a).group_name, mesh.get_local_rank(a),
                           axis_size(mesh, a)) for a in batch_names)
    for name, sh in shardings.items():
        computed = compute_placements(sh, plan, (axes or {}).get(name, ()), keep)
        for i, (p, kept) in enumerate(zip(computed, sh.placements)):
            if isinstance(kept, Shard) and not isinstance(p, Shard):
                stored[name] = stored.get(name, ()) + ((kept.dim, batch_names.index(names[i])),)
            if not isinstance(p, Shard):
                continue
            if names[i] in plan.batch_axes:
                dim, on = batch_dims.get(name, (p.dim, ()))
                batch_dims[name] = (dim, on + (batch_names.index(names[i]),))
            else:
                dims[name] = p.dim
                found.add(i)
    if len(found) > 1:
        raise NotImplementedError(
            f"tensor-parallel compute over more than one mesh axis "
            f"({[names[i] for i in sorted(found)]}) under plan {plan.name}")
    if found:
        axis = names[found.pop()]
    else:
        axis = next((a for a in plan.cache_seq_axes if a in names
                     and axis_size(mesh, a) > 1 and a not in plan.batch_axes), None)
    if axis is None:
        return TensorParallel(group="", rank=0, size=1, dims={}, batch=batch,
                              batch_dims=batch_dims, stored=stored)
    return TensorParallel(group=mesh.get_group(axis).group_name,
                          rank=mesh.get_local_rank(axis), size=axis_size(mesh, axis),
                          dims=dims, batch=batch, batch_dims=batch_dims, stored=stored)


def _axes_filter(mesh: DeviceMesh, axes: MeshAxes, used: set[str]) -> MeshAxes:
    """Drop mesh axes not present in the mesh or already used by this tensor."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    names = _names(mesh)
    picked = tuple(a for a in axes if a in names and a not in used)
    used.update(picked)
    if not picked:
        return None
    return picked if len(picked) > 1 else picked[0]


def spec_for_axes(
    mesh: DeviceMesh, logical_axes: Sequence[str | None], plan: ShardingPlan
) -> tuple[MeshAxes, ...]:
    used: set[str] = set()
    return tuple(_axes_filter(mesh, plan.lookup(a), used) for a in logical_axes)


def sharding_for_axes(
    mesh: DeviceMesh, logical_axes: Sequence[str | None], plan: ShardingPlan
) -> Sharding:
    return Sharding(mesh, spec_for_axes(mesh, logical_axes, plan))


def tree_shardings(
    mesh: DeviceMesh,
    axes: Mapping[str, Sequence[str | None]],
    plan: ShardingPlan,
    specs: Mapping[str, torch.Tensor] | None = None,
) -> dict[str, Sharding]:
    """Parameter name -> `Sharding` for a dict of logical-axis tuples.

    With `specs` (tensors of the same names, e.g. on the meta device),
    shardings are shape-sanitized: any dim whose size is not divisible by
    its mesh-axes product is replicated instead (an uneven split would
    pad the weight).
    """
    out = {name: sharding_for_axes(mesh, ax, plan) for name, ax in axes.items()}
    if specs is not None:
        out = {name: sh.sanitized(specs[name].shape) for name, sh in out.items()}
    return out


def batch_sharding(
    mesh: DeviceMesh, ndim: int, plan: ShardingPlan, *, seq_dim: int | None = 1
) -> Sharding:
    """Batch-dim sharding for an activation/batch tensor of rank `ndim`."""
    used: set[str] = set()
    dims: list[MeshAxes] = [_axes_filter(mesh, plan.batch_axes, used)]
    for d in range(1, ndim):
        if d == seq_dim and plan.seq_axes:
            dims.append(_axes_filter(mesh, plan.seq_axes, used))
        else:
            dims.append(None)
    return Sharding(mesh, tuple(dims))


def cache_sharding(
    mesh: DeviceMesh, spec_shape: tuple[int, ...], plan: ShardingPlan,
    *, seq_dim: int = 2,
) -> Sharding:
    """KV-cache sharding: batch over DP axes, cache sequence over
    `cache_seq_axes` (sequence-parallel decode attention).  seq_dim=2 for
    the [L,B,S,KV,D] layout, 3 for head-major [L,B,KV,S,D]."""
    used: set[str] = set()
    batch = _axes_filter(mesh, plan.batch_axes, used)
    seq = _axes_filter(mesh, plan.cache_seq_axes, used)
    dims: list[MeshAxes] = [None, batch] + [None] * (len(spec_shape) - 2)
    dims[seq_dim] = seq
    return Sharding(mesh, tuple(dims))


def ssm_cache_sharding(
    mesh: DeviceMesh, spec_shape: tuple[int, ...], plan: ShardingPlan
) -> Sharding:
    """SSM state [L, B, H, P, N] / conv [L, B, W, C]: batch over DP axes."""
    used: set[str] = set()
    batch = _axes_filter(mesh, plan.batch_axes, used)
    dims: list[MeshAxes] = [None, batch] + [None] * (len(spec_shape) - 2)
    return Sharding(mesh, tuple(dims))


def shard_placements(mesh: DeviceMesh, shards: int) -> tuple[torch.device, ...]:
    """Round-robin device assignment of `shards` logical fleet shards
    onto a ``shard``-axis mesh (`launch.mesh.make_fleet_mesh`): shard i
    refreshes on the mesh's device ``i % len``, so N shards on an
    N-device host get one device each and a larger fleet wraps around
    deterministically."""
    devs = [torch.device(mesh.device_type, int(i)) for i in mesh.mesh.flatten()]
    if not devs:
        raise ValueError("mesh has no devices")
    return tuple(devs[i % len(devs)] for i in range(max(0, int(shards))))
