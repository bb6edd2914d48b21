"""Multi-pod dry run: every (architecture x shape x mesh) cell's step,
run once on fake tensors over the production meshes, with its memory
and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh both --device cpu --out experiments/dryrun

In place of the reference's 512 forced host devices, each cell runs on a
``"fake"`` default process group of 512 ranks in this one process (rank
0 of it; no collective moves a byte), made by `run_cell` and destroyed
when the cell is done, also when it fails.  It is the only entry point
of the port that makes such a group, and it refuses to start while any
group is up.  The meshes are `make_production_mesh`'s: (data 16, model
16) over ranks 0-255, or (pod 2, data 16, model 16).

Per live cell it builds the port's step on `(mesh, plan)`
(`build_train_step` with the [accum, micro, ...] batch layout,
`build_prefill_step`, `build_serve_step`), places the state, batch and
caches as `shard_train_state`, `shard_params`, `batch_shardings_for` and
`cache_shardings_for` say, all under `FakeTensorMode` from `param_specs`,
`input_specs` and `cache_specs` (no byte is allocated on any device),
then runs ONE real call of the step under `analysis.roofline.OpCounter`.
So the row measures the program the port runs on rank 0, not GSPMD's:
the train and prefill steps compute on the rank's shards of the weights
the plan splits over ``model`` (`launch.steps`: Megatron column and row
products, vocab-parallel head and cross-entropy, expert-parallel MoE,
their all-reduces and all-gathers counted), and gather at use only what
is stored split over a batch axis; the serve step decodes each rank's
batch rows against its slices of the caches on its shards of the
weights (the softmax combined over ``model``, the MoE blocks' tokens
gathered over the batch axes), gathering no cache and no weight.

The row's keys are the reference's.  `memory`, in eager torch's terms
(per device, bytes):
- ``args_bytes``: this rank's local bytes of what the step is handed:
  parameters, AdamW moments, their count and the step count, and the
  batch (decode: parameters, caches and tokens; the index is a Python
  int, no tensor);
- ``output_bytes``: the local bytes of every tensor the step returns,
  new or updated in place (train: the state and the metrics; decode:
  the logits and the caches);
- ``alias_bytes``: the part of those that are arguments updated in place
  (parameters and moments, caches);
- ``temp_bytes``: the peak of live storage during the call beyond the
  arguments (gathered weights, activations, gradients), less the new
  outputs;
- ``total_per_device_gib``: (args + output + temp - alias) / 2**30, the
  reference's formula.

``costs`` are `OpCounter`'s per-device counts of the whole step (every
layer, chunk, microbatch and MoE group is dispatched, so nothing is
extrapolated), and ``scan_graph_costs``, the reference's production-graph
counts, are the same counts.  ``compile_s`` is the time to build the step
and place the fake state, ``delta_s`` the time of the counted call.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor

from ..analysis.roofline import CellCosts, OpCounter, model_flops, roofline
from ..configs import ASSIGNED, SHAPES, get_config, shape_applicable
from ..distributed.sharding import (
    BASELINE_PLAN,
    DECODE_PLAN,
    DP_ALL_PLAN,
    DP_FSDP_PLAN,
    Sharding,
    ShardingPlan,
    axis_size,
    batch_sharding,
)
from ..models import build_model
from ..models.transformer import check_device
from ..optim.adamw import AdamWConfig
from .mesh import make_production_mesh
from .steps import (
    batch_shardings_for,
    build_prefill_step,
    build_serve_step,
    build_train_step,
    cache_shardings_for,
    init_train_state,
    shard_params,
    shard_train_state,
)

PLANS = {
    "baseline": BASELINE_PLAN,
    "decode": DECODE_PLAN,
    "dp_all": DP_ALL_PLAN,
    "dp_fsdp": DP_FSDP_PLAN,
}

#: ranks of the fake group: the multi-pod mesh's
WORLD = 512


def _batch_axes_for(shape, mesh, plan) -> tuple[str, ...]:
    """Shard batch over as many DP axes as divide it (B=1 -> replicated)."""
    axes = []
    b = shape.global_batch
    names = mesh.mesh_dim_names or ()
    for ax in plan.batch_axes:
        if ax in names and b % axis_size(mesh, ax) == 0 and axis_size(mesh, ax) > 1:
            axes.append(ax)
            b //= axis_size(mesh, ax)
    return tuple(axes)


def _plan_for(cfg, shape, mesh, plan: ShardingPlan) -> ShardingPlan:
    rules = dict(plan.rules)
    model_size = axis_size(mesh, "model") if "model" in (mesh.mesh_dim_names or ()) else 1
    # GQA-aware TP: replicate KV projections when the KV head count does not
    # divide the TP degree (padding churn costs more than the tiny KV GEMM).
    if cfg.n_kv_heads and cfg.n_kv_heads % model_size != 0:
        rules["kv_heads"] = None
    return dataclasses.replace(
        plan, rules=rules, batch_axes=_batch_axes_for(shape, mesh, plan)
    )


#: train cells run with microbatch accumulation so activations fit HBM
#: (global batch 256 -> 4 microbatches of 64); part of the recorded baseline.
TRAIN_ACCUM = 4


@contextlib.contextmanager
def fake_group(world: int = WORLD):
    """A fake default process group of `world` ranks (this process is rank
    0), destroyed on exit; refused while a group is up."""
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised: the dry run makes its own "
            "fake group and needs none up"
        )
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tensors) -> int:
    """Local bytes of distinct storages (a DTensor counts its shard)."""
    seen = {}
    for t in tensors:
        t = t.to_local() if isinstance(t, DTensor) else t
        seen[t.untyped_storage()._cdata] = t.numel() * t.element_size()
    return sum(seen.values())


def _zeros(spec: torch.Tensor, device, size=None) -> torch.Tensor:
    return torch.zeros(size or spec.shape, dtype=spec.dtype, device=device)


def _place(t: torch.Tensor, sh: Sharding):
    """`t` on its mesh, as the step takes it (plain on one device)."""
    if sh.mesh.size() == 1:
        return t
    return distribute_tensor(t, sh.mesh, sh.placements)


def _state_tensors(state) -> list[torch.Tensor]:
    return (list(state.params.parameters()) + list(state.opt.mu.values())
            + list(state.opt.nu.values()) + [state.opt.count, state.step])


def _build_cell(model, shape, mesh, plan, device, *, triangular, accum, zero1):
    """(the cell's step, and `place`: a function that makes its arguments
    on fake tensors and returns them, their tensors, and a function from
    the step's result to its tensors).  The step is built outside the
    fake mode, its arguments are placed inside it.  Decode writes the
    last position of the cache (index seq_len - 1), so its attention
    reads the whole context."""
    specs = model.input_specs(shape)
    if shape.kind == "train":
        step, state_sh = build_train_step(
            model, mesh, plan, AdamWConfig(),
            accum_steps=accum, triangular=triangular, zero1=zero1,
        )

        def place():
            state = shard_train_state(init_train_state(model, device=device), state_sh)
            batch = {}
            for k, sh in batch_shardings_for(model, mesh, plan, specs).items():
                size = tuple(specs[k].shape)
                if accum > 1:
                    # host-side [accum, micro, ...] layout, micro over the batch axes
                    size = (accum, size[0] // accum) + size[1:]
                    sh = Sharding(mesh, (None,) + sh.spec)
                batch[k] = _place(_zeros(specs[k], device, size), sh)

            def outputs(result):
                new_state, metrics = result
                return _state_tensors(new_state) + list(metrics.values())

            return (state, batch), _state_tensors(state) + list(batch.values()), outputs
    elif shape.kind == "prefill":
        step, param_sh = build_prefill_step(model, mesh, plan, triangular=triangular)

        def place():
            module = shard_params(model.init(device=device), param_sh)
            batch = {k: _place(_zeros(specs[k], device), sh)
                     for k, sh in batch_shardings_for(model, mesh, plan, specs).items()}
            return ((module, batch), list(module.parameters()) + list(batch.values()),
                    lambda logits: [logits])
    else:  # decode
        step, param_sh = build_serve_step(model, mesh, plan, shape.seq_len)
        cache_specs = model.cache_specs(shape)
        cache_sh = cache_shardings_for(
            mesh, plan, cache_specs,
            seq_dim=3 if model.cfg.cache_layout == "bksd" else 2,
        )

        def place():
            module = shard_params(model.init(device=device), param_sh)
            caches = {k: _place(_zeros(s, device), cache_sh[k])
                      for k, s in cache_specs.items()}
            tokens = _place(_zeros(specs["tokens"], device), batch_sharding(mesh, 2, plan))

            def outputs(result):
                logits, new_caches = result
                return [logits] + list(new_caches.values())

            return ((module, caches, tokens, shape.seq_len - 1),
                    list(module.parameters()) + list(caches.values()) + [tokens], outputs)
    return step, place


def measure_cell(cfg, shape, mesh, plan: ShardingPlan, device, *,
                 triangular: bool = False, accum: int = 1, zero1: bool = True) -> dict:
    """One call of the cell's step on fake tensors under `OpCounter`:
    the `memory` dict, the `CellCosts`, and the build and call times."""
    model = build_model(cfg)
    plan = _plan_for(cfg, shape, mesh, plan)
    t0 = time.time()
    step, place = _build_cell(model, shape, mesh, plan, device,
                              triangular=triangular, accum=accum, zero1=zero1)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args, arg_tensors, outputs = place()
        t1 = time.time()
        counter = OpCounter()
        counter.known(arg_tensors)
        with counter:
            result = step(*args)
        t2 = time.time()
        out_tensors = outputs(result)
        args_bytes = _local_bytes(arg_tensors)
        output_bytes = _local_bytes(out_tensors)
        alias_bytes = args_bytes + output_bytes - _local_bytes(arg_tensors + out_tensors)
    temp_bytes = max(counter.peak_bytes - (output_bytes - alias_bytes), 0)
    memory = {
        "args_bytes": args_bytes,
        "output_bytes": output_bytes,
        "temp_bytes": temp_bytes,
        "alias_bytes": alias_bytes,
        "total_per_device_gib": round(
            (args_bytes + output_bytes + temp_bytes - alias_bytes) / 2**30, 3
        ),
    }
    return {"memory": memory, "costs": CellCosts.from_counter(counter),
            "build_s": t1 - t0, "call_s": t2 - t1}


def run_cell(
    arch: str,
    shape_name: str,
    mesh_name: str,
    *,
    plan_name: str = "",
    triangular: bool = False,
    skip_production: bool = False,
    accum: int | None = None,
    zero1: bool = True,
    attn_bf16: bool = False,
    attn_remat: bool = True,
    cache_bksd: bool = False,
    moe_wgather: bool = False,
    device="cuda",
) -> dict:
    cfg = get_config(arch)
    if moe_wgather:
        cfg = dataclasses.replace(cfg, moe_weight_gather=True)
    if attn_bf16:
        cfg = dataclasses.replace(cfg, attn_cast_f32=False)
    if not attn_remat:
        cfg = dataclasses.replace(cfg, attn_remat=False)
    if cache_bksd:
        cfg = dataclasses.replace(cfg, cache_layout="bksd")
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "skipped", "reason": reason,
        }
    device = check_device("dryrun", device)
    base_plan = PLANS[plan_name or ("decode" if shape.kind == "decode" else "baseline")]
    accum_steps = (TRAIN_ACCUM if accum is None else accum) if shape.kind == "train" else 1
    with fake_group():
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"),
                                    device_type=device.type)
        n_chips = mesh.size()
        out: dict = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "n_chips": n_chips, "plan": base_plan.name, "status": "ok",
            "triangular": triangular,
            "accum": accum_steps,
            "zero1": zero1,
            "attn_bf16": attn_bf16,
        }
        m = measure_cell(cfg, shape, mesh, base_plan, device, triangular=triangular,
                         accum=accum_steps, zero1=zero1)
    if not skip_production:
        out["compile_s"] = round(m["build_s"], 2)
        out["memory"] = m["memory"]
        out["scan_graph_costs"] = dataclasses.asdict(m["costs"])
    out["delta_s"] = round(m["call_s"], 2)
    rl = roofline(m["costs"], n_chips, model_flops(cfg, shape))
    out["costs"] = dataclasses.asdict(m["costs"])
    out["roofline"] = rl.as_dict()
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--plan", default="", help="override sharding plan")
    p.add_argument("--triangular", action="store_true")
    p.add_argument("--skip-production", action="store_true",
                   help="costs only (no memory or production-graph fields)")
    p.add_argument("--accum", type=int, default=-1,
                   help="train microbatch accumulation (-1 = default)")
    p.add_argument("--no-zero1", action="store_true")
    p.add_argument("--attn-bf16", action="store_true",
                   help="bf16 attention operands with f32 accumulation")
    p.add_argument("--no-attn-remat", action="store_true",
                   help="save q-block residuals instead of recomputing")
    p.add_argument("--cache-bksd", action="store_true",
                   help="head-major decode cache layout [B,KV,S,D]")
    p.add_argument("--moe-wgather", action="store_true",
                   help="gather expert weights over data at use")
    p.add_argument("--device", default="cuda",
                   help="device type of the mesh and the fake tensors (cuda needs a card)")
    p.add_argument("--out", default="experiments/dryrun")
    p.add_argument("--tag", default="")
    args = p.parse_args()

    archs = list(ASSIGNED) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                tag = f"{args.tag}_" if args.tag else ""
                path = os.path.join(
                    args.out, f"{tag}{mesh_name}__{arch}__{shape_name}.json"
                )
                t0 = time.time()
                try:
                    row = run_cell(
                        arch, shape_name, mesh_name,
                        plan_name=args.plan, triangular=args.triangular,
                        skip_production=args.skip_production,
                        accum=None if args.accum < 0 else args.accum,
                        zero1=not args.no_zero1,
                        attn_bf16=args.attn_bf16,
                        attn_remat=not args.no_attn_remat,
                        cache_bksd=args.cache_bksd,
                        moe_wgather=args.moe_wgather,
                        device=args.device,
                    )
                except Exception as e:
                    failures += 1
                    row = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "status": "error", "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                row["wall_s"] = round(time.time() - t0, 2)
                with open(path, "w") as f:
                    json.dump(row, f, indent=1)
                status = row["status"]
                extra = ""
                if status == "ok" and "roofline" in row:
                    r = row["roofline"]
                    extra = (
                        f" dom={r['dominant']} c={r['compute_s']:.2e}"
                        f" m={r['memory_s']:.2e} x={r['collective_s']:.2e}"
                        f" useful={r['useful_ratio']:.2f}"
                    )
                print(f"[{mesh_name}] {arch} x {shape_name}: {status}{extra} ({row['wall_s']}s)", flush=True)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
