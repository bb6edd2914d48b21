"""Device meshes (functions only: importing touches no device and no
process group).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims,
the axes a `ShardingPlan` names:
- `make_local_mesh` spans the ranks of this job's process group, or, in
  one process with no group, is the one device of that process (no
  group is needed: on it every placement is ``Replicate()``);
- `make_production_mesh` is the reference's production layout, 256
  ranks as (data 16, model 16) or 512 as (pod 2, data 16, model 16),
  over an initialised group of at least that many ranks;
- `make_fleet_mesh` is a one-process ``shard`` mesh over the host's
  devices, for the sharded fleet service.

The reference's roofline constants (its TPU figures) are not carried
over: the H100's belong to the dry run.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.transformer import check_device

__all__ = [
    "make_fleet_mesh",
    "make_local_mesh",
    "make_production_mesh",
]


def _one_process_mesh(device_type: str, ranks: torch.Tensor,
                      names: tuple[str, ...]) -> DeviceMesh:
    """A mesh of this process alone (rank 0), built without a process
    group: it names its dims and devices and runs no collective."""
    return DeviceMesh(device_type, ranks, mesh_dim_names=names,
                      _init_backend=False, _rank=0)


def make_production_mesh(multi_pod: bool = False, *, device_type: str = "cuda"
                         ) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = shape[0] * shape[1] * (shape[2] if multi_pod else 1)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_local_mesh(data: int | None = None, model: int = 1, *,
                    device="cuda") -> DeviceMesh:
    """A (data, model) mesh over the ranks of the default process group,
    or over this process's one device when no group is initialised.
    `device` names the device type (cuda raises without a card)."""
    device_type = check_device("make_local_mesh", device).type
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = max(1, n // model)
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh over {n} ranks")
    ranks = torch.arange(n).reshape(data, model)
    if not dist.is_initialized():
        return _one_process_mesh(device_type, ranks, ("data", "model"))
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def make_fleet_mesh(shards: int | None = None, *, device="cuda") -> DeviceMesh:
    """1-D ``shard`` mesh of this process over the host's devices of
    `device`'s type, one slot per worker shard: all of them, or `shards`
    of them when fewer; `distributed.sharding.shard_placements`
    round-robins more shards than devices onto it."""
    device_type = check_device("make_fleet_mesh", device).type
    count = torch.cuda.device_count() if device_type == "cuda" else 1
    n = count if shards is None else max(1, min(int(shards), count))
    return _one_process_mesh(device_type, torch.arange(n), ("shard",))
