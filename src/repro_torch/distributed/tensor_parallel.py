"""Tensor-parallel compute over the mesh's model axis: the context a step
hands the model, and Megatron's four collectives as autograd functions.

Every rank of the model axis holds the same activations (the batch is
split over other axes); a weight the plan splits over the model axis is
this rank's shard, and `TensorParallel.dim` names the dim it is split on.
The model code then runs Megatron's layout:
- a column product ``copy(x) @ w`` on the rank's columns: `copy` is the
  identity forward and all-reduces the input's gradient backward;
- a row product ``reduce(y @ w)`` on the rank's rows: `reduce`
  all-reduces forward and passes the gradient through backward;
- `gather` (all-gather forward, this rank's slice of the gradient
  backward) and `split` (this rank's slice forward, all-gather of the
  gradient backward), where an activation moves between a split and a
  whole layout;
- `max`, an all-reduce of a value that takes no gradient.

The context also names the mesh axes the batch is split over
(`batch`, major first): `gather_batch` puts the ranks' rows together
(all-gather forward, a reduce-scatter of the gradient backward: the
rows' gradient is summed over every rank that read them) and
`scatter_batch` takes this rank's rows back, reduce-scattered over the
batch axes a weight is split on (a serve step computes the experts on
their hidden dim's shard over ``data``, `batch_dim`), sliced over the
others.  The MoE block reads them to form the reference's global
dispatch groups.  A context of one rank on the model axis (``size``
1, no group) issues no model-axis collective.

A weight stored split over batch axes that the step computes whole
(FSDP: `DP_FSDP_PLAN`'s ``model``, `BASELINE_PLAN`'s experts' hidden
dim over ``data`` in a train or prefill step) is handed to the model as
its storage shard; `gathered` puts its whole copy in its module's place
for one block of code, one layer at a time (all-gather over the axes it
is stored on forward, a reduce-scatter of its gradient over the same
axes backward, `_GatherStored`), and the shard back after.  Inside a
layer under `torch.utils.checkpoint` the copy lives while the layer
computes, and the recompute gathers it again.

A decode step also reads `caches`: the keys of the caches whose
sequence is split over the model axis; the attention then combines its
softmax over the ranks with `all_max` and `all_sum`, collectives of
inference only (no autograd).

So a weight no rank splits, used on every rank by the same computation,
gets the same whole gradient on every rank, and a split weight's
gradient is its shard's.  The collectives are the functional ones
(``_c10d_functional``), each waited on at once: the dry run's
`OpCounter` counts them, and under `torch.utils.checkpoint` the
recomputed forward issues them again in the same order on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping

import torch
from torch import nn

__all__ = ["MeshAxis", "TensorParallel", "gathered"]

_ops = torch.ops._c10d_functional


def _all_reduce(x: torch.Tensor, op: str, group: str) -> torch.Tensor:
    return _ops.wait_tensor(_ops.all_reduce(x.contiguous(), op, group))


def _all_gather(x: torch.Tensor, dim: int, size: int, group: str) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`, in rank order."""
    y = _ops.all_gather_into_tensor(x.movedim(dim, 0).contiguous(), size, group)
    return _ops.wait_tensor(y).movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, size: int, group: str) -> torch.Tensor:
    """This rank's part along `dim` of `x` summed over the ranks."""
    y = _ops.reduce_scatter_tensor(x.movedim(dim, 0).contiguous(), "sum", size, group)
    return _ops.wait_tensor(y).movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.tp.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, "sum", tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _all_gather(x, dim, tp.size, tp.group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.tp.rank, ctx.tp.size), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _slice(x, dim, tp.rank, tp.size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.tp.size, ctx.tp.group), None, None


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        for axis in reversed(tp.batch):  # minor first: rows end up major-first
            x = _all_gather(x, dim, axis.size, axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        for axis in ctx.tp.batch:
            g = _reduce_scatter(g, ctx.dim, axis.size, axis.group)
        return g, None, None


class _GatherStored(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, on, tp):
        ctx.on, ctx.tp = on, tp
        for dim, i in reversed(on):  # minor first: a dim split twice ends up major-first
            w = _all_gather(w, dim, tp.batch[i].size, tp.batch[i].group)
        return w

    @staticmethod
    def backward(ctx, g):
        for dim, i in ctx.on:
            g = _reduce_scatter(g, dim, ctx.tp.batch[i].size, ctx.tp.batch[i].group)
        return g, None, None


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One mesh axis as a rank sees it: its group's name, this rank's
    index on it and its size."""

    group: str
    rank: int
    size: int


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place on the model axis: the axis' process group
    (its name), this rank's index on it and its size, and `dims`: for
    each parameter (by name) the plan splits over the axis, the dim it
    is split on.  `bind` ties the names to the tensors of one call, which
    `dim` then reads.  `batch`: the batch axes of more than one rank;
    `batch_dims`: for each parameter computed on its shard over batch
    axes, (the dim, the positions in `batch` of the axes it is split
    over); `stored`: for each parameter stored split over batch axes and
    computed whole, its (dim, position in `batch`) pairs in mesh order,
    which `gathered` gathers.  `caches`: the caches split over the model
    axis."""

    group: str
    rank: int
    size: int
    dims: Mapping[str, int]
    bound: dict[int, int] = dataclasses.field(default_factory=dict)
    batch: tuple[MeshAxis, ...] = ()
    batch_dims: Mapping[str, tuple[int, tuple[int, ...]]] = dataclasses.field(
        default_factory=dict)
    batch_bound: Mapping[int, tuple[int, tuple[int, ...]]] = dataclasses.field(
        default_factory=dict)
    stored: Mapping[str, tuple[tuple[int, int], ...]] = dataclasses.field(
        default_factory=dict)
    stored_bound: Mapping[int, tuple[tuple[int, int], ...]] = dataclasses.field(
        default_factory=dict)
    caches: frozenset = frozenset()

    def bind(self, tensors: Mapping[str, torch.Tensor]) -> "TensorParallel":
        """This context for the model's `tensors`, by parameter name."""
        def by_id(table):
            return {id(t): table[n] for n, t in tensors.items() if n in table}

        return dataclasses.replace(self, bound=by_id(self.dims),
                                   batch_bound=by_id(self.batch_dims),
                                   stored_bound=by_id(self.stored))

    def dim(self, w: torch.Tensor | None) -> int | None:
        """The dim of `w` that is this rank's shard, None when `w` is whole."""
        return None if w is None else self.bound.get(id(w))

    def batch_dim(self, w: torch.Tensor | None) -> int | None:
        """The dim of `w` that is this rank's shard over batch axes."""
        return None if w is None else self.batch_bound.get(id(w), (None,))[0]

    @property
    def batch_size(self) -> int:
        """The ranks the batch is split over."""
        n = 1
        for axis in self.batch:
            n *= axis.size
        return n

    def gather_batch(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' rows of `x` along `dim`, in the batch's global order."""
        return _GatherBatch.apply(x, dim % x.dim(), self) if self.batch else x

    def scatter_batch(self, x: torch.Tensor, dim: int = 0,
                      w: torch.Tensor | None = None) -> torch.Tensor:
        """This rank's rows of `x` (the global batch along `dim`): summed
        over the batch axes `w` is split on (`x` a partial sum there), a
        slice over the others; the sum takes no gradient."""
        axes = self.batch_bound.get(id(w), (None, ()))[1] if w is not None else ()
        for i, axis in enumerate(self.batch):
            if i in axes:
                x = _reduce_scatter(x, dim, axis.size, axis.group)
            else:
                x = _slice(x, dim, axis.rank, axis.size)
        return x

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """`x`'s max over the model axis (no autograd)."""
        return x if self.size == 1 else _all_reduce(x, "max", self.group)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """`x` summed over the model axis (no autograd)."""
        return x if self.size == 1 else _all_reduce(x, "sum", self.group)

    def start(self, local: int) -> int:
        """The global index of this rank's first of `local` rows of a split dim."""
        return self.rank * local

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _Gather.apply(x, dim % x.dim(), self)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _Split.apply(x, dim % x.dim(), self)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_max(x.detach())


@contextlib.contextmanager
def gathered(tp: TensorParallel | None, module: nn.Module, skip: tuple[str, ...] = ()):
    """Within the block, each weight of `module` (but those under its
    submodules named in `skip`) that `tp` has stored split over batch
    axes is its whole copy, gathered there (`_GatherStored`; its model
    axis split, if any, is its shard's); the shard is put back after,
    so nothing holds the copy but what the block's autograd saved."""
    if tp is None or not tp.stored_bound:
        yield
        return
    swapped = []
    for name, owner in module.named_modules():
        if name.split(".")[0] in skip:
            continue
        for leaf, w in owner._parameters.items():
            on = None if w is None else tp.stored_bound.get(id(w))
            if on is None:
                continue
            whole = _GatherStored.apply(w, on, tp)
            if id(w) in tp.bound:
                tp.bound[id(whole)] = tp.bound[id(w)]
            owner._parameters[leaf] = whole
            swapped.append((owner, leaf, w, whole))
    try:
        yield
    finally:
        for owner, leaf, w, whole in swapped:
            owner._parameters[leaf] = w
            tp.bound.pop(id(whole), None)
