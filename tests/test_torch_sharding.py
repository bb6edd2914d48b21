"""The port's sharding layer against the reference's, on the CPU.

- Every parameter's spec (`tree_shardings`, shape sanitisation included)
  for all eleven configs x the four plans x the meshes (1, 1), (16, 16)
  and (2, 16, 16): the port's meshes are `DeviceMesh`es of a fake
  512-rank process group in this process, the reference's
  `AbstractMesh`es.  The reference stacks each per-layer leaf on a
  leading "layer" dim, which every plan replicates and the port's
  per-layer parameters do not have.
- The conflict-resolution and sanitisation cases of the reference's
  tests, the DTensor placements a spec means, `input_specs` /
  `cache_specs` for every family, kind and cache layout, and the ZeRO-1
  moment placements.
- `compress_grads` bit for bit, and the reference's two properties.
- A train step on two Gloo ranks (one process each) under `DP_ALL_PLAN`
  on (2, 1) with ZeRO-1 and `BASELINE_PLAN` on (1, 2), against the
  one-device step from the same weights, itself held against the
  reference's step, and with two microbatches a step; on the same
  ranks the prefill step under each plan
  and twelve decode steps under `DECODE_PLAN` (the caches placed by
  `cache_shardings_for`) against the one-device steps.
- ZeRO-1's stacked moments (C14): every moment's bytes a device equal
  the reference's, hymba-1.5b's SSM vectors stacked over its 32 layers;
  the stacks through `shard_train_state`, `tree` and `load`.
- Tensor-parallel compute under `BASELINE_PLAN`: the port's train step
  and prefill on 2 and 4 Gloo ranks, (1, 2) and (2, 2), against the
  reference's own GSPMD steps on 2 and 4 forced CPU devices (a fresh
  interpreter with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
  as `tests/conftest.py`'s shard rig sets it) for paper-gpt-125m and
  phi3.5-moe reduced; paper-gpt, hymba and mamba2 reduced on (1, 2)
  against the port's one-device step, biases and norm scales drawn; the
  SSD scan split over `model` (mamba2 on (1, 2) and (1, 4), hymba on
  (1, 4)) and the attention split over query blocks (one row: paper-gpt
  on (1, 2) and (1, 4), the prefill also under ``triangular``, whisper
  on (1, 2)) against the same, every whole parameter equal on all ranks.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.distributed import compression as ref_compression  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch.mesh import make_local_mesh as ref_local_mesh  # noqa: E402
from repro.launch.steps import build_train_step as ref_build_train_step  # noqa: E402
from repro.launch.steps import init_train_state as ref_init_train_state  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro_torch.configs import ARCHITECTURES, ShapeConfig, get_config  # noqa: E402
from repro_torch.distributed import compression, sharding  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.transformer import LAYER_STACKS, params_from_jax  # noqa: E402
from repro_torch.optim import AdamWConfig, lr_at  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = ("BASELINE_PLAN", "DECODE_PLAN", "DP_ALL_PLAN", "DP_FSDP_PLAN")
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


@pytest.fixture
def fake_group():
    """A fake 512-rank default process group in this process (no
    collective runs), torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=512, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meshes(name):
    """The port's mesh on the fake group (the production meshes from
    `make_production_mesh`) and the reference's abstract one."""
    shape, names = MESHES[name]
    if name == "1x1":
        port = DeviceMesh("cpu", torch.zeros(shape, dtype=torch.int64),
                          mesh_dim_names=names)
    else:
        port = port_mesh.make_production_mesh(len(shape) == 3, device_type="cpu")
    assert tuple(port.shape) == shape and port.mesh_dim_names == names
    return port, AbstractMesh(shape, names)


def _padded(spec, rank):
    spec = tuple(spec)
    return spec + (None,) * (rank - len(spec))


def _ref_leaves(tree, prefix=""):
    """A reference tree of specs flattened to dotted names; the stacked
    layer leaves split per layer, their leading "layer" dim dropped."""
    out = {}
    for key, node in tree.items():
        name = f"{prefix}{key}"
        if isinstance(node, dict):
            out.update(_ref_leaves(node, name + "."))
        else:
            out[name] = node
    return out


_SPECS = {}


def _port_specs(arch):
    if arch not in _SPECS:
        model = build_model(get_config(arch))
        _SPECS[arch] = (model, steps.param_specs(model))
    return _SPECS[arch]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_tree_shardings_equal_the_reference(fake_group, arch, plan, mesh_name):
    model, specs = _port_specs(arch)
    rmodel = ref_build_model(ref_config(arch))
    rspec = jax.eval_shape(lambda: rmodel.init(jax.random.PRNGKey(0)))
    port_m, ref_m = _meshes(mesh_name)
    ref_sh = ref_sharding.tree_shardings(
        ref_m, rmodel.param_axes(), getattr(ref_sharding, plan), rspec)
    ref_specs = _ref_leaves(jax.tree.map(lambda s: s.spec, ref_sh,
                                         is_leaf=lambda x: hasattr(x, "spec")))
    ref_shapes = _ref_leaves(jax.tree.map(lambda s: s.shape, rspec))
    got = sharding.tree_shardings(port_m, model.param_axes(),
                                  getattr(sharding, plan), specs)
    assert set(got) == set(specs)
    stacked = model.cfg.scan_layers
    for name, sh in got.items():
        head, *rest = name.split(".")
        if head in LAYER_STACKS and stacked:
            key = ".".join([head] + rest[1:])
            want = _padded(ref_specs[key], len(ref_shapes[key]))
            assert want[0] is None, (name, want)
            want = want[1:]
        else:
            key = name
            want = _padded(ref_specs[key], len(ref_shapes[key]))
        assert _padded(sh.spec, specs[name].dim()) == want, name
        assert len(sh.placements) == port_m.ndim


def test_spec_conflict_resolution(fake_group):
    mesh, _ = _meshes("1x1")
    plan = sharding.BASELINE_PLAN
    # expert + expert_mlp: expert wins model, expert_mlp takes data
    spec = sharding.spec_for_axes(mesh, ("expert", "embed", "expert_mlp"), plan)
    assert spec[0] == "model" and spec[2] == "data"
    # duplicate mesh axis is dropped first-come-first-served
    spec2 = sharding.spec_for_axes(mesh, ("heads", "mlp"), plan)
    assert spec2[0] == "model" and spec2[1] is None


def test_shape_sanitization(fake_group):
    small, _ = _meshes("1x1")
    axes = {"w": ("embed", "mlp"), "v": ("vocab", "embed")}
    specs = {"w": torch.empty((7, 6482), device="meta"),
             "v": torch.empty((51968, 8), device="meta")}
    # model axis size 1 divides everything: stays
    sh = sharding.tree_shardings(small, axes, sharding.BASELINE_PLAN, specs)
    assert sh["w"].spec[1] == "model"
    big, _ = _meshes("16x16")
    sh = sharding.tree_shardings(big, axes, sharding.BASELINE_PLAN, specs)
    assert sh["w"].spec == (None, None)  # 6482 % 16 != 0
    assert sh["v"].spec == ("model", None)  # 51,968 = 16 x 3,248
    assert sh["v"].placements == (Replicate(), Shard(0))


def test_placements_follow_the_mesh_order(fake_group):
    mesh, _ = _meshes("2x16x16")
    batch = sharding.batch_sharding(mesh, 2, sharding.BASELINE_PLAN)
    assert batch.spec == (("pod", "data"), None)
    assert batch.placements == (Shard(0), Shard(0), Replicate())
    dp = sharding.batch_sharding(mesh, 2, sharding.DP_ALL_PLAN)
    assert dp.placements == (Shard(0),) * 3
    backwards = sharding.Sharding(mesh, (("data", "pod"), None))
    with pytest.raises(ValueError, match="order"):
        backwards.placements


@pytest.mark.parametrize("layout", ["bskd", "bksd"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_input_and_cache_specs_equal_the_reference(arch, kind, layout):
    rcfg = dataclasses.replace(ref_config(arch), cache_layout=layout)
    cfg = dataclasses.replace(get_config(arch), cache_layout=layout)
    rmodel, model = ref_build_model(rcfg), build_model(cfg)
    rshape, shape = RefShape("s", 512, 8, kind), ShapeConfig("s", 512, 8, kind)
    for got, want in ((model.input_specs(shape), rmodel.input_specs(rshape)),
                      (model.cache_specs(shape), rmodel.cache_specs(rshape))):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name, k
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch", ["paper-gpt-125m", "hymba-1.5b", "mamba2-130m",
                                  "whisper-base"])
def test_cache_specs_are_the_caches(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    module = model.init(device="cpu")
    caches = model.init_caches(module, 2, 40)
    specs = model.cache_specs(ShapeConfig("s", 40, 2, "decode"))
    assert sorted(caches) == sorted(specs)
    for k, c in caches.items():
        assert c.shape == specs[k].shape and c.dtype == specs[k].dtype, k


def _spec_bytes(spec, shape, sizes, itemsize=4) -> int:
    """Bytes a device of a tensor of `shape` under `spec` (mesh axis sizes
    `sizes` by name)."""
    n = 1
    for dim, size in zip(_padded(spec, len(shape)), shape):
        for a in (() if dim is None else (dim,) if isinstance(dim, str) else dim):
            assert size % sizes[a] == 0
            size //= sizes[a]
        n *= size
    return n * itemsize


@pytest.mark.parametrize("plan", ["BASELINE_PLAN", "DP_ALL_PLAN"])
@pytest.mark.parametrize("arch", ["paper-gpt-125m", "phi3.5-moe-42b-a6.6b",
                                  "whisper-base", "hymba-1.5b"])
def test_zero1_moments_equal_the_reference(fake_group, arch, plan):
    """Each moment's spec is the reference's, its stacked "layer" dim
    dropped, and its bytes a device are the reference's.  Where the
    reference's ZeRO-1 puts ``data`` on that layer dim (n_layers a
    multiple of 16: phi3.5-moe's and hymba's 32), the port's per-layer
    leaf takes ``data`` on the first of its own dims that 16 divides, as
    the same rule on the per-layer shape does; a leaf with no such dim
    (hymba's SSM vectors, conv and norms) keeps its moments stacked over
    the layers under the reference's key, with the reference's spec."""
    port_m, ref_m = _meshes("16x16")
    sizes = dict(zip(MESHES["16x16"][1], MESHES["16x16"][0]))
    rmodel = ref_build_model(ref_config(arch))
    _, ref_sh = ref_build_train_step(rmodel, ref_m, getattr(ref_sharding, plan))
    spec_of = lambda tree: _ref_leaves(jax.tree.map(
        lambda s: s.spec, tree, is_leaf=lambda x: hasattr(x, "spec")))
    ref_mu, ref_params = spec_of(ref_sh.opt.mu), spec_of(ref_sh.params)
    rspec = _ref_leaves(jax.tree.map(lambda s: s.shape, jax.eval_shape(
        lambda: rmodel.init(jax.random.PRNGKey(0)))))
    model, specs = _port_specs(arch)
    _, state_sh = steps.build_train_step(model, port_m, getattr(sharding, plan))
    on_layer = 0
    got_bytes: dict[str, int] = {}
    for name, sh in state_sh.moments.items():
        if name in state_sh.stacks:
            members = state_sh.stacks[name]
            assert [n.split(".")[1] for n in members] == [
                str(i) for i in range(len(members))]
            shape = (len(members),) + tuple(specs[members[0]].shape)
            assert _padded(sh.spec, len(shape)) == _padded(ref_mu[name], len(shape)), name
            got_bytes[name] = _spec_bytes(sh.spec, shape, sizes)
            on_layer += 1
            continue
        head, *rest = name.split(".")
        stacked = head in LAYER_STACKS
        key = ".".join([head] + rest[1:]) if stacked else name
        got = _padded(sh.spec, specs[name].dim())
        want = _padded(ref_mu[key], len(rspec[key]))
        got_bytes[key] = got_bytes.get(key, 0) + _spec_bytes(got, specs[name].shape, sizes)
        if stacked and want[0] == "data":
            on_layer += 1
            # the rule on the per-layer leaf: the parameter's spec, then
            # `data` on its first unsharded dim that 16 divides
            want = list(_padded(ref_params[key], len(rspec[key]))[1:])
            for i, size in enumerate(specs[name].shape):
                if want[i] is None and size % 16 == 0:
                    want[i] = "data"
                    break
            assert got == tuple(want), name
            continue
        assert got == want[int(stacked):], name
    assert (on_layer > 0) == (model.cfg.n_layers % 16 == 0)
    assert got_bytes == {k: _spec_bytes(ref_mu[k], rspec[k], sizes) for k in ref_mu}


def test_stacked_moments_round_trip(fake_group):
    """The stacked moments through `shard_train_state`, `TrainState.tree`
    and `TrainState.load`: hymba reduced at 16 layers on (16, 16), whose
    SSM vectors (8 heads) take no ``data``; each stack holds the layers'
    moments in layer order."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_layers=16)
    model = build_model(cfg)
    mesh, _ = _meshes("16x16")
    _, state_sh = steps.build_train_step(model, mesh, sharding.BASELINE_PLAN)
    assert "layers.ssm.A_log" in state_sh.stacks
    assert state_sh.moments["layers.ssm.A_log"].spec == ("data", None)
    state = steps.init_train_state(model, device="cpu")
    for i, (name, t) in enumerate(state.opt.mu.items()):
        t.copy_(torch.arange(t.numel(), dtype=t.dtype).reshape(t.shape) + i)
    want = {n: t.clone() for n, t in state.opt.mu.items()}
    state = steps.shard_train_state(state, state_sh)
    assert set(state.opt.mu) == set(state_sh.moments)
    for key, names in state_sh.stacks.items():
        local = state.opt.mu[key].to_local()
        assert local.shape[0] == 1  # layer 0 on this rank of 16, its first shard
        first = want[names[0]][tuple(slice(0, n) for n in local.shape[1:])]
        assert torch.equal(local[0], first), key
    other = steps.shard_train_state(steps.init_train_state(model, device="cpu"), state_sh)
    other.load(state.tree())
    for n, t in state.opt.mu.items():
        assert torch.equal(other.opt.mu[n].to_local(), t.to_local()), n


def test_one_device_mesh_needs_no_group():
    assert not dist.is_initialized()
    mesh = port_mesh.make_local_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    sh = sharding.tree_shardings(mesh, {"w": ("embed", "heads")},
                                 sharding.BASELINE_PLAN)
    assert sh["w"].placements == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        port_mesh.make_local_mesh(2, 1, device="cpu")
    fleet = port_mesh.make_fleet_mesh(4, device="cpu")
    assert fleet.mesh_dim_names == ("shard",)
    assert sharding.shard_placements(fleet, 3) == (torch.device("cpu", 0),) * 3
    model = build_model(get_config("paper-gpt-125m").reduced())
    step, state_sh = steps.build_train_step(model, mesh, sharding.BASELINE_PLAN)
    state = steps.init_train_state(model, device="cpu")
    assert steps.shard_train_state(state, state_sh) is state
    assert not any(isinstance(p, torch.distributed.tensor.DTensor)
                   for p in state.params.parameters())


def test_meshes_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_local_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_fleet_mesh()


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------


def test_compress_grads_equal_the_reference_bitwise():
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=(64, 33)).astype(np.float32) * 3,
         "b": rng.normal(size=7).astype(np.float32) * 1e-3,
         "z": np.zeros(5, np.float32)}
    ref_ef = ref_compression.init_ef({k: jnp.asarray(v) for k, v in g.items()})
    ef = compression.init_ef({k: torch.from_numpy(v) for k, v in g.items()})
    for step in range(5):
        gs = {k: v * (step + 1) - step for k, v in g.items()}
        want, ref_ef = ref_compression.compress_grads(
            {k: jnp.asarray(v) for k, v in gs.items()}, ref_ef)
        got, ef = compression.compress_grads(
            {k: torch.from_numpy(v) for k, v in gs.items()}, ef)
        for k in g:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            np.testing.assert_array_equal(ef.error[k].numpy(), np.asarray(ref_ef.error[k]))


def test_error_feedback_converges():
    """EF-int8 SGD tracks the uncompressed trajectory on average."""
    rng = np.random.default_rng(0)
    g_seq = [{"w": torch.from_numpy(rng.normal(size=64).astype(np.float32))}
             for _ in range(100)]
    ef = compression.init_ef(g_seq[0])
    acc_c = np.zeros(64)
    acc_u = np.zeros(64)
    for g in g_seq:
        cg, ef = compression.compress_grads(g, ef)
        acc_c += cg["w"].numpy()
        acc_u += g["w"].numpy()
    assert np.abs(acc_c - acc_u).max() < 0.05


def test_quantization_bounded_error():
    g = {"w": torch.from_numpy(np.linspace(-3, 3, 101, dtype=np.float32))}
    cg, _ = compression.compress_grads(g, compression.init_ef(g))
    scale = 3.0 / 127
    assert float((cg["w"] - g["w"]).abs().max()) <= scale * 0.51 + 1e-6


# ---------------------------------------------------------------------------
# A train step on two Gloo ranks against the one-device step
# ---------------------------------------------------------------------------

_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import (
    build_prefill_step, build_serve_step, build_train_step, cache_shardings_for,
    init_train_state, shard_params, shard_train_state)
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig

rank, init, case_path, plan, data, model_axis, out_path = (
    int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]),
    int(sys.argv[6]), sys.argv[7])
torch.set_num_threads(1)  # the ranks start at once and share the cores
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=data * model_axis)
case = torch.load(case_path, weights_only=False)
model = build_model(case["cfg"])
mesh = make_local_mesh(data, model_axis, device="cpu")
step, state_sh = build_train_step(model, mesh, getattr(sharding, plan),
                                  AdamWConfig(**case["opt"]), zero1=True)
state = init_train_state(model, device="cpu")
state.params.load_state_dict(case["params"])
state = shard_train_state(state, state_sh)
before = {n: [repr(p) for p in t.placements] for n, t in state.params.named_parameters()}
mu = {n: [repr(p) for p in t.placements] for n, t in state.opt.mu.items()}
local = {n: list(t.to_local().shape) for n, t in state.opt.mu.items()}
state, m = step(state, case["batch"])
params = {n: p.full_tensor() for n, p in state.params.named_parameters()}
moments = {n: t.full_tensor() for n, t in state.opt.mu.items()}

# two microbatches a step: [accum, micro, S] leaves, micro over the batch axes
accum_step, _ = build_train_step(model, mesh, getattr(sharding, plan),
                                 AdamWConfig(**case["opt"]), accum_steps=2)
accum_state = init_train_state(model, device="cpu")
accum_state.params.load_state_dict(case["params"])
accum_state = shard_train_state(accum_state, state_sh)
accum_state, am = accum_step(accum_state, case["accum_batch"])
accum_params = {n: p.full_tensor() for n, p in accum_state.params.named_parameters()}

# prefill under the same plan, then decode under DECODE_PLAN from the
# starting weights, the caches placed as the plan says
module = model.init(device="cpu")
module.load_state_dict(case["params"])
prefill, param_sh = build_prefill_step(model, mesh, getattr(sharding, plan))
shard_params(module, param_sh)
logits = prefill(module, {"tokens": case["batch"]["tokens"]}).full_tensor()
tokens = case["decode_tokens"]
b, seq = tokens.shape
serve, _ = build_serve_step(model, mesh, sharding.DECODE_PLAN, seq)
cache_sh = cache_shardings_for(mesh, sharding.DECODE_PLAN,
                               model.cache_specs(ShapeConfig("d", seq, b, "decode")))
caches = {k: distribute_tensor(c, mesh, cache_sh[k].placements)
          for k, c in model.init_caches(module, b, seq, device="cpu").items()}
cache_pl = {k: [repr(p) for p in c.placements] for k, c in caches.items()}
decoded = []
for i in range(seq):
    out, caches = serve(module, caches, tokens[:, i:i + 1], i)
    decoded.append(out.full_tensor())
uneven = None
if "uneven_batch" in case:  # each rank's tokens no whole number of groups
    uneven_state = init_train_state(model, device="cpu")
    uneven_state.params.load_state_dict(case["params"])
    uneven_state, um = step(shard_train_state(uneven_state, state_sh), case["uneven_batch"])
    uneven = dict(loss=float(um["loss"]), grad_norm=float(um["grad_norm"]), params={
        n: p.full_tensor() for n, p in uneven_state.params.named_parameters()})
if rank == 0:
    torch.save(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                    params=params, mu=moments, placements=before, mu_placements=mu,
                    mu_local=local, step=int(state.step), prefill=logits,
                    decode=torch.stack(decoded), cache_placements=cache_pl,
                    uneven=uneven,
                    accum=dict(loss=float(am["loss"]), grad_norm=float(am["grad_norm"]),
                               params=accum_params)), out_path)
print(json.dumps({"rank": rank, "ok": True}), flush=True)
dist.destroy_process_group()
"""

_OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10)


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _gloo_ranks(script, tmp_path, tag, case_path, plan, data, model_axis):
    """(the data x model_axis rank processes of `script` on one Gloo
    group, started; the file rank 0 writes)."""
    init = f"file://{tmp_path / f'gloo_{tag}'}"
    out = tmp_path / f"{tag}.pt"
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(r), init, str(case_path), plan, str(data),
         str(model_axis), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
        for r in range(data * model_axis)], out


def _wait(procs, seconds=240):
    deadline = time.monotonic() + seconds
    try:
        for p in procs:
            _, stderr = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, stderr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _gloo_step(tmp_path, case_path, plan, data, model_axis):
    procs, out = _gloo_ranks(_RANK, tmp_path, plan, case_path, plan, data, model_axis)
    _wait(procs)
    return torch.load(out, weights_only=False)


def _ref_batch(arch, seq):
    """The reference's step from its seed-0 weights on a batch of 4 x
    `seq` (the first half has more ignored labels than the second), and
    those weights and the batch as the port's."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, seq)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, seq)).astype(np.int32)}
    batch["labels"][:2, :12] = -1
    batch["labels"][3, -3:] = -1
    mesh = ref_local_mesh(1, 1)
    with mesh:
        ref_step, _ = ref_build_train_step(ref_build_model(rcfg), mesh,
                                           ref_sharding.BASELINE_PLAN,
                                           RefAdamWConfig(**_OPT))
        state = ref_init_train_state(ref_build_model(rcfg), jax.random.PRNGKey(0))
        start = jax.tree.map(np.asarray, state.params)
        state, m = ref_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        ref = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   params=params_from_jax(jax.tree.map(np.asarray, state.params), cfg))
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    return cfg, ref, params_from_jax(start, cfg), tensors


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """The reference's step and the port's one-device step from the same
    weights and batch (paper-gpt-125m reduced, 4 x 32)."""
    return _one_device(tmp_path_factory, *_ref_batch("paper-gpt-125m", 32))


@pytest.fixture(scope="module")
def one_device_moe(tmp_path_factory):
    """The same for phi3.5-moe reduced on 4 x 64: dispatch groups of 64
    tokens, so on two ranks each holds two groups a step (one a
    microbatch of two); a 2 x 96 batch gives each rank 96 tokens, no
    whole number of groups."""
    cfg, ref, weights, tensors = _ref_batch("phi3.5-moe-42b-a6.6b", 64)
    rng = np.random.default_rng(4)
    uneven = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 96)).astype(np.int32))
              for k in ("tokens", "labels")}
    return _one_device(tmp_path_factory, cfg, ref, weights, tensors, uneven_batch=uneven)


def _one_device(tmp_path_factory, cfg, ref, weights, tensors, **extra):
    model = build_model(cfg)
    port_state = steps.init_train_state(model, device="cpu")
    port_state.params.load_state_dict(weights)
    step, _ = steps.build_train_step(model, port_mesh.make_local_mesh(device="cpu"),
                                     sharding.BASELINE_PLAN, AdamWConfig(**_OPT))
    port_state, pm = step(port_state, tensors)
    one = dict(loss=float(pm["loss"]), grad_norm=float(pm["grad_norm"]),
               params={n: p.detach().clone() for n, p in port_state.params.named_parameters()},
               mu=dict(port_state.opt.mu))
    accum_batch = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in tensors.items()}
    accum_step, _ = steps.build_train_step(model, port_mesh.make_local_mesh(device="cpu"),
                                           sharding.BASELINE_PLAN, AdamWConfig(**_OPT),
                                           accum_steps=2)
    accum_state = steps.init_train_state(model, device="cpu")
    accum_state.params.load_state_dict(weights)
    accum_state, am = accum_step(accum_state, accum_batch)
    one["accum"] = dict(loss=float(am["loss"]), grad_norm=float(am["grad_norm"]),
                        params=dict(accum_state.params.named_parameters()))
    # the one-device prefill and teacher-forced decode from the starting weights
    module = model.init(device="cpu")
    module.load_state_dict(weights)
    prefill, _ = steps.build_prefill_step(model, port_mesh.make_local_mesh(device="cpu"),
                                          sharding.BASELINE_PLAN)
    one["prefill"] = prefill(module, {"tokens": tensors["tokens"]})
    decode_tokens = tensors["tokens"][:, :12].contiguous()
    serve, _ = steps.build_serve_step(model, port_mesh.make_local_mesh(device="cpu"),
                                      sharding.DECODE_PLAN, 12)
    caches = model.init_caches(module, 4, 12)
    one["decode"] = torch.stack([serve(module, caches, decode_tokens[:, i:i + 1], i)[0]
                                 for i in range(12)])
    if "uneven_batch" in extra:  # a step from the starting weights on the uneven batch
        state = steps.init_train_state(model, device="cpu")
        state.params.load_state_dict(weights)
        state, um = step(state, extra["uneven_batch"])
        one["uneven"] = dict(loss=float(um["loss"]), grad_norm=float(um["grad_norm"]), params={
            n: p.detach().clone() for n, p in state.params.named_parameters()})
    case_path = tmp_path_factory.mktemp("gloo_case") / "case.pt"
    torch.save(dict(cfg=cfg, opt=_OPT, params=weights, batch=tensors,
                    accum_batch=accum_batch, decode_tokens=decode_tokens, **extra),
               case_path)
    return dict(ref=ref, one=one, case=case_path,
                lr=float(lr_at(AdamWConfig(**_OPT), torch.zeros(()))))


def _close_params(got, want, lr):
    """99.9 % of elements within 1e-6, every element within 2 x lr."""
    off = total = 0
    for name, w in want.items():
        diff = (got[name].detach().double() - w.detach().double()).abs()
        assert float(diff.max()) <= 2 * lr, name
        off += int((diff > 1e-6).sum())
        total += diff.numel()
    assert off <= 0.001 * total, (off, total)


def _equals_the_reference(case):
    ref, one = case["ref"], case["one"]
    assert one["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert one["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-5)
    _close_params(one["params"], ref["params"], case["lr"])


def test_one_device_step_equals_the_reference(one_device):
    _equals_the_reference(one_device)


def test_one_device_moe_step_equals_the_reference(one_device_moe):
    _equals_the_reference(one_device_moe)


@pytest.mark.parametrize("plan,data,model_axis", [("DP_ALL_PLAN", 2, 1),
                                                  ("BASELINE_PLAN", 1, 2)])
def test_two_gloo_ranks_equal_the_one_device_step(one_device, tmp_path, plan, data,
                                                  model_axis):
    """Loss and grad norm within rtol 1e-6, every parameter and moment as
    `_close_params` holds them: under DP_ALL_PLAN the data-parallel sum
    adds the two halves' gradients in another order than the one-device
    step; under BASELINE_PLAN on (1, 2) each rank computes on its shards
    of the weights (Megatron column and row products, the vocab-parallel
    cross-entropy), whose row products add two half contractions."""
    got = _gloo_step(tmp_path, one_device["case"], plan, data, model_axis)
    one = one_device["one"]
    assert got["step"] == 1
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-6)
    assert got["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-6)
    _close_params(got["params"], one["params"], one_device["lr"])
    _close_params(got["mu"], one["mu"], one_device["lr"])
    # two microbatches a step, each split over the batch axes
    assert got["accum"]["loss"] == pytest.approx(one["accum"]["loss"], rel=1e-6)
    assert got["accum"]["grad_norm"] == pytest.approx(one["accum"]["grad_norm"], rel=1e-6)
    _close_params(got["accum"]["params"], one["accum"]["params"], one_device["lr"])
    # each rank decodes its batch rows on its shards of the weights (and,
    # on (1, 2), its half of the cache sequence, the softmax combined over
    # `model`), and the prefill of a batch split over `data` runs two
    # half-batch products: both within 1e-5
    torch.testing.assert_close(got["decode"], one["decode"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["prefill"], one["prefill"], rtol=1e-5, atol=1e-5)
    if plan == "BASELINE_PLAN":
        # DECODE_PLAN on (1, 2): the cache sequence over `model`
        assert got["cache_placements"]["k"] == ["Replicate()", "Shard(dim=2)"]
        assert got["placements"]["layers.0.attn.wq"] == ["Replicate()", "Shard(dim=1)"]
        assert got["placements"]["layers.0.attn.wo"] == ["Replicate()", "Shard(dim=0)"]
        assert got["placements"]["embed"] == ["Replicate()", "Shard(dim=0)"]
        assert got["placements"]["final_norm.scale"] == ["Replicate()", "Replicate()"]
    else:
        assert all(p == ["Replicate()", "Replicate()"]
                   for p in got["placements"].values()), got["placements"]
        # ZeRO-1: each moment on the first dim `data` divides
        assert got["mu_placements"]["embed"] == ["Shard(dim=0)", "Replicate()"]
        assert got["mu_local"]["embed"][0] * 2 == one["mu"]["embed"].shape[0]
        assert got["mu_placements"]["layers.0.attn.wq"] == ["Shard(dim=0)", "Replicate()"]
        # DECODE_PLAN on (2, 1): the cache batch over `data`
        assert got["cache_placements"]["k"] == ["Shard(dim=1)", "Replicate()"]


def test_two_gloo_ranks_moe_equal_the_one_device_step(one_device_moe, tmp_path):
    """phi3.5-moe under DP_ALL_PLAN on (2, 1), the ignored labels split
    unevenly: each rank weights the cross-entropy by its share of the
    supervised tokens and the load-balance term by its share of the
    batch, so the step is the one-device step within the tolerances of
    the dense case; a batch whose rank shards are no whole number of
    dispatch groups (96 tokens a rank, groups of 64) gathers the MoE
    blocks' input over `data` and routes the global groups (C15), so it
    too is the one-device step within those tolerances."""
    got = _gloo_step(tmp_path, one_device_moe["case"], "DP_ALL_PLAN", 2, 1)
    one, lr = one_device_moe["one"], one_device_moe["lr"]
    assert got["step"] == 1
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-6)
    assert got["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-6)
    _close_params(got["params"], one["params"], lr)
    _close_params(got["mu"], one["mu"], lr)
    assert got["accum"]["loss"] == pytest.approx(one["accum"]["loss"], rel=1e-6)
    assert got["accum"]["grad_norm"] == pytest.approx(one["accum"]["grad_norm"], rel=1e-6)
    _close_params(got["accum"]["params"], one["accum"]["params"], lr)
    torch.testing.assert_close(got["decode"], one["decode"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["prefill"], one["prefill"], rtol=1e-5, atol=1e-5)
    uneven, want = got["uneven"], one["uneven"]
    assert uneven["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert uneven["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-6)
    _close_params(uneven["params"], want["params"], lr)


# ---------------------------------------------------------------------------
# Tensor-parallel steps on Gloo ranks against the reference's GSPMD step
# ---------------------------------------------------------------------------

#: the reference's train and prefill steps under BASELINE_PLAN on a CPU
#: mesh of forced host devices (XLA_FLAGS is read when jax loads, so in
#: a fresh interpreter); the prefill first, from the seed-0 weights the
#: train step then donates
_REF_MESH = r"""
import pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.distributed import sharding
from repro.launch.mesh import _axis_type_kwargs
from repro.launch.steps import build_prefill_step, build_train_step, init_train_state
from repro.models import build_model
from repro.optim import AdamWConfig

arch, case_path, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
with open(case_path, "rb") as f:
    case = pickle.load(f)
model = build_model(get_config(arch).reduced())
out = {}
for data, model_axis in case["meshes"]:
    mesh = jax.make_mesh((data, model_axis), ("data", "model"),
                         devices=jax.devices()[:data * model_axis], **_axis_type_kwargs(2))
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
    with mesh:
        prefill, _ = build_prefill_step(model, mesh, sharding.BASELINE_PLAN,
                                        batch_specs={"tokens": specs["tokens"]})
        state = init_train_state(model, jax.random.PRNGKey(0))
        logits = np.asarray(prefill(state.params, {"tokens": batch["tokens"]}))
        step, _ = build_train_step(model, mesh, sharding.BASELINE_PLAN,
                                   AdamWConfig(**case["opt"]), batch_specs=specs)
        state, m = step(state, batch)
        out[(data, model_axis)] = dict(
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), prefill=logits,
            params=jax.tree.map(np.asarray, state.params))
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""

#: one train step and the prefill on Gloo ranks, from the case's weights
_TP_RANK = r"""
import sys
import torch
import torch.distributed as dist
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import (
    build_prefill_step, build_train_step, init_train_state, shard_params, shard_train_state)
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig

rank, init, case_path, plan, data, model_axis, out_path = (
    int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]),
    int(sys.argv[6]), sys.argv[7])
torch.set_num_threads(1)  # the ranks start at once and share the cores
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=data * model_axis)
case = torch.load(case_path, weights_only=False)
model = build_model(case["cfg"])
mesh = make_local_mesh(data, model_axis, device="cpu")
plan = case.get("plan") or getattr(sharding, plan)
module = model.init(device="cpu")
module.load_state_dict(case["params"])
prefill, param_sh = build_prefill_step(model, mesh, plan)
logits = prefill(shard_params(module, param_sh),
                 {k: v for k, v in case["batch"].items() if k != "labels"})
step, state_sh = build_train_step(model, mesh, plan, AdamWConfig(**case["opt"]))
state = init_train_state(model, device="cpu")
state.params.load_state_dict(case["params"])
state, m = step(shard_train_state(state, state_sh), case["batch"])
params = {n: p.full_tensor() for n, p in state.params.named_parameters()}
full = logits.full_tensor()
# every rank's copy of each whole parameter, against rank 0's
whole = {n: p.to_local() for n, p in state.params.named_parameters()
         if all(pl.is_replicate() for pl in p.placements)}
copies = [None] * dist.get_world_size()
dist.all_gather_object(copies, whole)
spread = {n: max(float((c[n] - w).abs().max()) for c in copies) for n, w in whole.items()}
tri = None
if case.get("triangular"):
    prefill, _ = build_prefill_step(model, mesh, plan, triangular=True)
    module = model.init(device="cpu")
    module.load_state_dict(case["params"])
    tri = prefill(shard_params(module, param_sh),
                  {k: v for k, v in case["batch"].items() if k != "labels"}).full_tensor()
if rank == 0:
    torch.save(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), params=params,
                    prefill=full, logits_placements=[repr(p) for p in logits.placements],
                    logits_local=list(logits.to_local().shape),
                    stacks=sorted(state_sh.stacks), whole_spread=spread,
                    prefill_triangular=tri), out_path)
dist.destroy_process_group()
"""

#: (arch, data, model): the reference's own step on the same mesh
TP_REF_CASES = [("paper-gpt-125m", 1, 2), ("paper-gpt-125m", 2, 2),
                ("phi3.5-moe-42b-a6.6b", 1, 2), ("phi3.5-moe-42b-a6.6b", 2, 2)]
#: against the port's one-device step: name -> (arch reduced, config
#: changes, plan rules changed from BASELINE_PLAN's or another plan's
#: name, (data, model)[, `_tp_case` options]).  Under DP_FSDP_PLAN `model`
#: carries the batch, so every weight is stored split and gathered at use,
#: in the layer that reads it, its gradient reduce-scattered; the MoE
#: family's experts on (2, 2) are stored split on two dims over two axes
#: (experts over `model`, their hidden dim over `data`).
#: Whole KV projections (the dry run's GQA rule) make each rank slice the
#: KV heads its query heads read; 3 heads split a head across the 2
#: ranks, so the projections are gathered whole (from the shard of ``wq``,
#: from column slices of the whole ``wk``/``wv``) and the attention split
#: over (batch, kv head) groups; the hybrid and the SSM split the SSD
#: projections; the encoder-decoder's cross-attention reads the encoder's
#: states; on (2, 2) a hidden dim of 127 leaves the MLP whole and
#: ``bi`` with no dim `data` divides, so ZeRO-1 stacks its moments.
#: The split scan: d_inner 192 in 6 heads of 32, so on (1, 4) a rank's 48
#: channels are 1.5 heads, and ``in_proj``'s 422 columns are no multiple
#: of 4 (each rank a 4th of the first 420, all of the last 2); hymba on
#: (1, 4) splits its scan (2 of 8 heads a rank) beside its windowed
#: attention (32 positions of 64) on Megatron heads.  The query split: one
#: row, so neither 1 x 1 KV head nor 3 heads divide the axis; 64 positions
#: in zigzag blocks of 16 (one 32-row block a rank is halved), the prefill
#: also under ``triangular``; whisper's encoder (16 frames) and
#: cross-attention in contiguous rows, its decoder in zigzag blocks.
_SPLIT_SCAN = {"ssm_expand": 3, "ssm_head_dim": 32}
_QUERY_SPLIT = {"n_heads": 3, "n_kv_heads": 1}
TP_ONE_CASES = {
    "dense": ("paper-gpt-125m", {}, {}, (1, 2)),
    "dense-kv-whole": ("paper-gpt-125m", {}, {"kv_heads": None}, (1, 2)),
    "dense-3-heads-kv-whole": ("paper-gpt-125m", {"n_heads": 3, "n_kv_heads": 3},
                               {"kv_heads": None}, (1, 2)),
    "dense-stacked-moments": ("paper-gpt-125m", {"d_ff": 127}, {}, (2, 2)),
    "hybrid": ("hymba-1.5b", {}, {}, (1, 2)),
    "ssm": ("mamba2-130m", {}, {}, (1, 2)),
    "encdec": ("whisper-base", {}, {}, (1, 2)),
    "fsdp": ("paper-gpt-125m", {}, "DP_FSDP_PLAN", (1, 2)),
    "fsdp-moe": ("phi3.5-moe-42b-a6.6b", {}, "DP_FSDP_PLAN", (1, 2)),
    "fsdp-moe-2x2": ("phi3.5-moe-42b-a6.6b", {}, "DP_FSDP_PLAN", (2, 2)),
    "ssm-split-scan-1x2": ("mamba2-130m", _SPLIT_SCAN, {}, (1, 2)),
    "ssm-split-scan-1x4": ("mamba2-130m", _SPLIT_SCAN, {}, (1, 4)),
    "hybrid-split-1x4": ("hymba-1.5b", {}, {}, (1, 4)),
    "query-split-1x2": ("paper-gpt-125m", _QUERY_SPLIT, {}, (1, 2),
                        {"batch": 1, "triangular": True}),
    "query-split-1x4": ("paper-gpt-125m", _QUERY_SPLIT, {}, (1, 4),
                        {"batch": 1, "triangular": True}),
    "encdec-query-split-1x2": ("whisper-base", {"n_heads": 3, "n_kv_heads": 3}, {}, (1, 2),
                               {"batch": 1}),
}


def _tp_case(arch, changes, rules, batch=4, seq=64, triangular=False):
    """The case for the ranks: `arch` reduced (with `changes`), its seed-0
    weights with every bias and norm scale drawn away from its 0 or 1 (so
    one added on the wrong side of an all-reduce shows), a `batch` x `seq`
    batch, and the plan `rules` names, or BASELINE_PLAN with `rules`;
    with `triangular`, the prefill is also run under it."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    model = build_model(cfg)
    rng = np.random.default_rng(5)
    tokens = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, seq)).astype(np.int32))
              for k in ("tokens", "labels")}
    tokens["labels"][:2, :5] = -1
    batch_ = {k: v[:batch].clone() for k, v in tokens.items()}
    if cfg.family == "encdec":
        batch_["frames"] = torch.from_numpy(rng.normal(
            0, 1, (batch, seq // cfg.enc_seq_divisor, cfg.d_model)).astype(np.float32))
    weights = {n: p.detach().clone() if p.dim() > 1 else
               p.detach() + torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32))
               for n, p in model.init(device="cpu").state_dict().items()}
    plan = (getattr(sharding, rules) if isinstance(rules, str) else dataclasses.replace(
        sharding.BASELINE_PLAN, rules={**sharding.BASELINE_PLAN.rules, **rules}))
    return dict(cfg=cfg, opt=_OPT, params=weights, batch=batch_, plan=plan,
                triangular=triangular)


def _one_device_tp(case):
    """The port's one-device train step and prefill (and, where the case
    asks, the prefill under ``triangular``) of a `_tp_case`."""
    model, weights, batch = build_model(case["cfg"]), case["params"], case["batch"]
    mesh = port_mesh.make_local_mesh(device="cpu")
    module = model.init(device="cpu")
    module.load_state_dict(weights)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    prefill, _ = steps.build_prefill_step(model, mesh, sharding.BASELINE_PLAN)
    logits = prefill(module, inputs)
    tri = None
    if case["triangular"]:
        prefill, _ = steps.build_prefill_step(model, mesh, sharding.BASELINE_PLAN,
                                              triangular=True)
        tri = prefill(module, inputs)
    step, _ = steps.build_train_step(model, mesh, sharding.BASELINE_PLAN, AdamWConfig(**_OPT))
    state = steps.init_train_state(model, device="cpu")
    state.params.load_state_dict(weights)
    state, m = step(state, batch)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), prefill=logits,
                prefill_triangular=tri,
                params={n: p.detach().clone() for n, p in state.params.named_parameters()})


@pytest.fixture(scope="module")
def tp_runs(one_device, one_device_moe, tmp_path_factory):
    """Every tensor-parallel case at once: the reference's steps on 2- and
    4-device CPU meshes (one interpreter an arch) and the port's on 2 and
    4 Gloo ranks, started together; while they run, the port's
    one-device steps of `TP_ONE_CASES`."""
    tmp = tmp_path_factory.mktemp("tp")
    cases = {"paper-gpt-125m": one_device, "phi3.5-moe-42b-a6.6b": one_device_moe}
    one_cases = {name: _tp_case(*spec[:3], **(spec[4:] or [{}])[0])
                 for name, spec in TP_ONE_CASES.items()}
    for name, case in one_cases.items():
        torch.save(case, tmp / f"{name}.pt")
    procs, outs = [], {}
    for arch, fixture in cases.items():
        case = torch.load(fixture["case"], weights_only=False)
        with open(tmp / f"{arch}.pkl", "wb") as f:
            pickle.dump(dict(batch={k: v.numpy() for k, v in case["batch"].items()},
                             opt=_OPT, meshes=[(d, m) for a, d, m in TP_REF_CASES
                                               if a == arch]), f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REF_MESH, arch, str(tmp / f"{arch}.pkl"),
             str(tmp / f"{arch}.ref")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=_env(JAX_PLATFORMS="cpu",
                                XLA_FLAGS="--xla_force_host_platform_device_count=4")))
    for arch, data, model_axis in TP_REF_CASES:
        ranks, outs[arch, data, model_axis] = _gloo_ranks(
            _TP_RANK, tmp, f"{arch}_{data}x{model_axis}", cases[arch]["case"],
            "BASELINE_PLAN", data, model_axis)
        procs += ranks
    for name, (*_, (data, model_axis)) in ((n, spec[:4]) for n, spec in TP_ONE_CASES.items()):
        ranks, outs[name] = _gloo_ranks(_TP_RANK, tmp, f"one_{name}", tmp / f"{name}.pt",
                                        "BASELINE_PLAN", data, model_axis)
        procs += ranks
    try:
        # the one-device step of a case split on several meshes, once
        same = {name: (spec[:2], spec[4:]) for name, spec in TP_ONE_CASES.items()}
        ones = {}
        for name, case in one_cases.items():
            first = next(n for n in one_cases if same[n] == same[name])
            ones[name] = ones[first] if first in ones else _one_device_tp(case)
    finally:
        _wait(procs, 300)
    ref = {}
    for arch in cases:
        with open(tmp / f"{arch}.ref", "rb") as f:
            ref[arch] = pickle.load(f)
    return dict(port={k: torch.load(v, weights_only=False) for k, v in outs.items()},
                ref=ref, ones=ones, lr=one_device["lr"])


@pytest.mark.parametrize("arch,data,model_axis", TP_REF_CASES)
def test_tensor_parallel_step_equals_the_reference(tp_runs, arch, data, model_axis):
    """BASELINE_PLAN on (1, 2) and (2, 2): each rank computes on its
    shards of the weights (heads, mlp, vocab and experts over `model`,
    the experts' hidden dim gathered over `data`), against the
    reference's GSPMD step on as many CPU devices: loss and grad norm
    within rel 1e-5, parameters by `_close_params`, prefill logits within
    1e-5, the logits split over the vocab on `model`."""
    got, want = tp_runs["port"][arch, data, model_axis], tp_runs["ref"][arch][data, model_axis]
    cfg = get_config(arch).reduced()
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    _close_params(got["params"], params_from_jax(want["params"], cfg), tp_runs["lr"])
    torch.testing.assert_close(got["prefill"], torch.from_numpy(want["prefill"]),
                               rtol=1e-5, atol=1e-5)
    assert got["logits_placements"][1] == "Shard(dim=2)"
    assert got["logits_local"] == [4 // data, want["prefill"].shape[1],
                                   cfg.padded_vocab // model_axis]


@pytest.mark.parametrize("case", sorted(TP_ONE_CASES))
def test_tensor_parallel_step_equals_the_one_device_step(tp_runs, case):
    """Under BASELINE_PLAN (`TP_ONE_CASES`), against the port's one-device
    step with biases and norm scales drawn: the dense family's ``bi``,
    ``bo`` and qkv biases each on its side of the all-reduce, in each of
    the attention's layouts; the hybrid (sliding-window attention beside
    the SSD mixer) and the SSM family's ``in_proj`` a column product
    gathered before its split, the conv on each rank's channels,
    ``out_proj`` a row product; the scan on each rank's slice of d_inner,
    its gated norm's sum of squares all-reduced; the attention split over
    query blocks, the prefill also under ``triangular``; the
    encoder-decoder's self- and cross-attention; ZeRO-1's stacked moments
    updated and written back to their layers.  After the step every whole
    parameter (``A_log``, ``D``, ``dt_bias``, the norms, a whole
    ``in_proj``, ...) is the same on every rank."""
    got, one = tp_runs["port"][case], tp_runs["ones"][case]
    assert ("layers.mlp.bi" in got["stacks"]) == (case == "dense-stacked-moments")
    # the logits' vocab over `model` where the plan computes on its shards
    assert (got["logits_placements"][1] == "Shard(dim=2)") == (not case.startswith("fsdp"))
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-5)
    _close_params(got["params"], one["params"], tp_runs["lr"])
    torch.testing.assert_close(got["prefill"], one["prefill"], rtol=1e-5, atol=1e-5)
    if one["prefill_triangular"] is not None:
        torch.testing.assert_close(got["prefill_triangular"], one["prefill_triangular"],
                                   rtol=1e-5, atol=1e-5)
    spread = got["whole_spread"]
    assert spread and not {n: d for n, d in spread.items() if d != 0.0}
    if "ssm" in case or "hybrid" in case:
        assert {f"layers.0.ssm.{n}" for n in ("A_log", "D", "dt_bias")} <= set(spread)


#: a weight stored split over `data` on two Gloo ranks, gathered for a
#: block by `tensor_parallel.gathered`: what the block reads, the full
#: tensor, and the gradient of a loss each rank weights with its own
#: coefficients, against the shard of the whole gradient
_GATHER_RANK = r"""
import sys
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import distribute_tensor
from repro_torch.distributed import sharding
from repro_torch.distributed.tensor_parallel import gathered
from repro_torch.launch.mesh import make_local_mesh

rank, init, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)  # the ranks start at once and share the cores
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
mesh = make_local_mesh(2, 1, device="cpu")
gen = torch.Generator().manual_seed(0)
out = {}
for dim in (0, 1):
    whole = torch.randn(6, 4, generator=gen)
    coef = torch.randn(2, 6, 4, generator=gen)  # rank r's loss: sum(w * coef[r])
    sh = sharding.Sharding(mesh, ("data", None) if dim == 0 else (None, "data"))
    w = distribute_tensor(whole, mesh, sh.placements)
    shard = w.to_local().detach().requires_grad_(True)
    tp = sharding.tensor_parallel({"w": sh}, sharding.BASELINE_PLAN).bind({"w": shard})
    module = nn.Module()
    module.register_parameter("w", nn.Parameter(torch.empty(0)))
    module._parameters["w"] = shard
    with gathered(tp, module):
        seen = module.w
        loss = (seen * coef[rank]).sum()
    grad, = torch.autograd.grad(loss, shard)
    out[dim] = dict(seen=seen.detach(), full=w.full_tensor(), whole=whole,
                    grad=grad, want=coef.sum(0).chunk(2, dim)[rank],
                    stored=tp.stored, restored=module.w is shard)
torch.save(out, out_path + f".{rank}")
dist.destroy_process_group()
"""


def test_gathered_weight_is_the_full_tensor_and_its_gradient_is_reduce_scattered(tmp_path):
    """`tensor_parallel.gathered` on two Gloo ranks, a [6, 4] weight
    stored split over `data` on dim 0 and on dim 1: inside the block the
    module reads the whole weight, equal to the DTensor's `full_tensor()`
    bit for bit; after it, the shard again; the gradient of the ranks'
    different losses is the sum of both ranks' gradients, this rank's
    shard of it, within 1e-6 (a reduce-scatter)."""
    init = f"file://{tmp_path / 'gloo_gather'}"
    out = tmp_path / "gather.pt"
    procs = [subprocess.Popen([sys.executable, "-c", _GATHER_RANK, str(r), init, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env()) for r in range(2)]
    _wait(procs, 120)
    for rank in range(2):
        got = torch.load(f"{out}.{rank}", weights_only=False)
        for dim, case in got.items():
            assert case["stored"] == {"w": ((dim, 0),)}
            assert torch.equal(case["seen"], case["full"])
            assert torch.equal(case["seen"], case["whole"])
            assert case["restored"]
            assert case["grad"].shape == case["want"].shape
            torch.testing.assert_close(case["grad"], case["want"], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Sequence-parallel decode on Gloo ranks against the reference's GSPMD step
# ---------------------------------------------------------------------------

#: the reference's serve step under DECODE_PLAN (the caches by its
#: `cache_shardings_for`, the tokens over the batch axes) on CPU meshes of
#: forced host devices, teacher-forced from the case's weights and tokens
_REF_SERVE = r"""
import pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
import dataclasses
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.distributed import sharding
from repro.launch.mesh import _axis_type_kwargs
from repro.launch.steps import build_serve_step
from repro.models import build_model

cases_path, data, model_axis, out_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
with open(cases_path, "rb") as f:
    cases = pickle.load(f)
mesh = jax.make_mesh((data, model_axis), ("data", "model"),
                     devices=jax.devices()[:data * model_axis], **_axis_type_kwargs(2))
out = {}
for name, case in cases.items():
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["changes"])
    model = build_model(cfg)
    tokens = jnp.asarray(case["tokens"])
    b, seq = tokens.shape
    params = jax.tree.map(jnp.asarray, case["ref_params"])
    with mesh:
        serve, _ = build_serve_step(model, mesh, sharding.DECODE_PLAN, seq,
                                    cache_specs=model.cache_specs(ShapeConfig("d", seq, b, "decode")),
                                    token_batch=b)
        frames = None if case["frames"] is None else jnp.asarray(case["frames"])
        caches = model.init_caches(params, b, seq, frames=frames)
        logits = []
        for i in range(seq):
            lg, caches = serve(params, caches, tokens[:, i:i + 1], jnp.int32(i))
            logits.append(np.asarray(lg))
    out[name] = dict(logits=np.stack(logits), caches={k: np.asarray(v) for k, v in caches.items()})
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""

#: the port's serve step under DECODE_PLAN on Gloo ranks, every case in
#: turn on one group; each step under `OpCounter`, `DTensor.full_tensor`
#: and every `redistribute` that changes a placement recorded
_SERVE_RANK = r"""
import sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.analysis.roofline import OpCounter
from repro_torch.configs import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import build_serve_step, cache_shardings_for, shard_params
from repro_torch.models import build_model

rank, init, cases_path, _, data, model_axis, out_path = (
    int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]),
    int(sys.argv[6]), sys.argv[7])
torch.set_num_threads(1)  # the ranks start at once and share the cores
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=data * model_axis)
mesh = make_local_mesh(data, model_axis, device="cpu")
plan = sharding.DECODE_PLAN
moved = []
full_tensor, redistribute = DTensor.full_tensor, DTensor.redistribute


def recorded_full(self, *a, **k):
    moved.append(("full_tensor", tuple(self.shape)))
    return full_tensor(self, *a, **k)


def recorded_redistribute(self, device_mesh=None, placements=None, *a, **k):
    if placements is not None and tuple(placements) != tuple(self.placements):
        moved.append(("redistribute", tuple(self.shape)))
    return redistribute(self, device_mesh, placements, *a, **k)


out = {}
for name, case in torch.load(cases_path, weights_only=False).items():
    cfg, tokens, frames = case["cfg"], case["tokens"], case["frames"]
    model = build_model(cfg)
    b, seq = tokens.shape
    module = model.init(device="cpu")
    module.load_state_dict(case["params"])
    whole = model.init_caches(module, b, seq, device="cpu", frames=frames)
    serve, param_sh = build_serve_step(model, mesh, plan, seq)
    shard_params(module, param_sh)
    at = mesh.mesh_dim_names.index("model")
    split = sum(p.numel() * p.element_size() for n, p in module.named_parameters()
                if sharding.compute_placements(param_sh[n], plan)[at].is_shard())
    cache_sh = cache_shardings_for(mesh, plan, model.cache_specs(ShapeConfig("d", seq, b, "decode")),
                                   seq_dim=3 if cfg.cache_layout == "bksd" else 2)
    caches = {k: distribute_tensor(c, mesh, cache_sh[k].placements) for k, c in whole.items()}
    logits, gathered = [], 0.0
    for i in range(seq):
        DTensor.full_tensor, DTensor.redistribute = recorded_full, recorded_redistribute
        try:
            with OpCounter() as counter:
                lg, caches = serve(module, caches, tokens[:, i:i + 1], i)
        finally:
            DTensor.full_tensor, DTensor.redistribute = full_tensor, redistribute
        gathered += counter.coll_by_kind["all-gather"]
        logits.append(lg.full_tensor())
    out[name] = dict(logits=torch.stack(logits),
                     caches={k: c.full_tensor() for k, c in caches.items()},
                     cache_placements={k: [repr(p) for p in c.placements] for k, c in caches.items()},
                     logits_placements=[repr(p) for p in lg.placements],
                     logits_local=list(lg.to_local().shape),
                     all_gather_bytes=gathered, split_weight_bytes=split, moved=list(moved))
    moved.clear()
if rank == 0:
    torch.save(out, out_path)
dist.destroy_process_group()
"""

#: name -> (arch reduced, config changes, batch, steps): every step's
#: logits and the final caches against the reference's on each of
#: `SERVE_MESHES`.  The steps cross the cache's halves, so the write
#: moves from rank 0's slice to rank 1's; hymba's 44 steps wrap its
#: 32-position ring buffer; 25 positions do not divide `model`, so that
#: cache stays whole (batch split only); whisper's 16 steps give 4
#: encoder frames, its cross caches split too; the MoE's 8 rows form one
#: global group of 8 where a rank of (2, 2) holds 4, and capacity drops.
SERVE_CASES = {
    "dense": ("paper-gpt-125m", {}, 4, 20),
    "dense-bksd": ("paper-gpt-125m", {"cache_layout": "bksd"}, 4, 20),
    "dense-probs-rounded": ("paper-gpt-125m", {"attn_cast_f32": False}, 4, 20),
    "dense-bksd-probs-rounded": ("paper-gpt-125m",
                                 {"cache_layout": "bksd", "attn_cast_f32": False}, 4, 20),
    "hybrid": ("hymba-1.5b", {}, 4, 44),
    "hybrid-window-25": ("hymba-1.5b", {"window": 25}, 4, 30),
    "ssm": ("mamba2-130m", {}, 4, 12),
    "moe": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 1.0}, 8, 12),
    "encdec": ("whisper-base", {}, 4, 16),
}
SERVE_MESHES = [(1, 2), (2, 2)]


def _serve_case(arch, changes, batch, steps_):
    """The reference's seed-0 weights of `arch` reduced (with `changes`),
    as its tree and as the port's, seeded tokens (and frames)."""
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    tree = jax.tree.map(np.asarray, ref_build_model(rcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (batch, steps_)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = rng.normal(0, 1, (batch, steps_ // cfg.enc_seq_divisor, cfg.d_model)
                            ).astype(np.float32)
    return dict(arch=arch, changes=changes, cfg=cfg, ref_params=tree,
                params=params_from_jax(tree, cfg), tokens=tokens, frames=frames)


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Every `SERVE_CASES` case on both meshes at once: the reference's
    serve step on 2 and 4 forced CPU devices (one interpreter a mesh) and
    the port's on 2 and 4 Gloo ranks (one process a rank, every case in
    turn); while they run, the port's one-device decode of the MoE case,
    of its whole batch and of each half."""
    tmp = tmp_path_factory.mktemp("serve")
    cases = {name: _serve_case(*spec) for name, spec in SERVE_CASES.items()}
    with open(tmp / "ref.pkl", "wb") as f:
        pickle.dump({n: {k: c[k] for k in ("arch", "changes", "ref_params", "tokens", "frames")}
                     for n, c in cases.items()}, f)
    torch.save({n: dict(cfg=c["cfg"], params=c["params"], tokens=torch.from_numpy(c["tokens"]),
                        frames=None if c["frames"] is None else torch.from_numpy(c["frames"]))
                for n, c in cases.items()}, tmp / "port.pt")
    procs, outs = [], {}
    for data, model_axis in SERVE_MESHES:
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REF_SERVE, str(tmp / "ref.pkl"), str(data), str(model_axis),
             str(tmp / f"ref_{data}x{model_axis}.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")))
        ranks, outs[data, model_axis] = _gloo_ranks(
            _SERVE_RANK, tmp, f"serve_{data}x{model_axis}", tmp / "port.pt", "DECODE_PLAN",
            data, model_axis)
        procs += ranks
    try:
        moe = cases["moe"]
        model = build_model(moe["cfg"])
        module = model.init(device="cpu")
        module.load_state_dict(moe["params"])
        tokens = torch.from_numpy(moe["tokens"])
        grouped, drops = {}, []
        for label, rows in (("global", slice(None)), ("first", slice(0, 4)),
                            ("second", slice(4, 8))):
            t = tokens[rows]
            caches = model.init_caches(module, t.shape[0], t.shape[1], device="cpu")
            hooks = [layer.moe.register_forward_pre_hook(
                lambda m, args: drops.append(int(moe_lib.dropped(m, args[0], m.cfg))))
                for layer in module.layers] if label == "global" else []
            grouped[label] = torch.stack([model.decode_step(
                module, caches, t[:, i:i + 1], i, t.shape[1])[0] for i in range(t.shape[1])])
            for hook in hooks:
                hook.remove()
    finally:
        _wait(procs, 300)
    ref = {}
    for data, model_axis in SERVE_MESHES:
        with open(tmp / f"ref_{data}x{model_axis}.pkl", "rb") as f:
            ref[data, model_axis] = pickle.load(f)
    return dict(port={k: torch.load(v, weights_only=False) for k, v in outs.items()}, ref=ref,
                cases=cases, grouped=grouped, drops=drops)


def _expected_cache_placements(cfg, key, shape, data, model_axis):
    """The placements `DECODE_PLAN` gives cache `key` on a (data,
    model_axis) mesh: the batch over `data`; an attention cache's
    sequence over `model` where it divides."""
    batch = "Shard(dim=1)" if data > 1 else "Replicate()"
    if key not in ("k", "v", "cross_k", "cross_v"):
        return [batch, "Replicate()"]
    seq = 3 if cfg.cache_layout == "bksd" and cfg.family != "encdec" else 2
    return [batch, f"Shard(dim={seq})" if shape[seq] % model_axis == 0 else "Replicate()"]


@pytest.mark.parametrize("data,model_axis", SERVE_MESHES)
@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_sequence_parallel_serve_step_equals_the_reference(serve_runs, case, data, model_axis):
    """DECODE_PLAN on (1, 2) and (2, 2): each rank decodes its batch rows
    against its own slices of the caches on its shards of the weights,
    the softmax combined over `model`; every step's logits and every
    final cache against the reference's GSPMD serve step on as many CPU
    devices within 1e-5 (f32), the caches placed as the plan says and the
    logits split over the vocab on `model`."""
    got, want = serve_runs["port"][data, model_axis][case], serve_runs["ref"][data, model_axis][case]
    cfg = serve_runs["cases"][case]["cfg"]
    torch.testing.assert_close(got["logits"], torch.from_numpy(want["logits"]),
                               rtol=1e-5, atol=1e-5)
    assert sorted(got["caches"]) == sorted(want["caches"])
    for key, cache in got["caches"].items():
        torch.testing.assert_close(cache, torch.from_numpy(want["caches"][key]),
                                   rtol=1e-5, atol=1e-5, msg=key)
        assert got["cache_placements"][key] == _expected_cache_placements(
            cfg, key, tuple(cache.shape), data, model_axis), key
    b = serve_runs["cases"][case]["tokens"].shape[0]
    assert got["logits_placements"] == ["Shard(dim=0)" if data > 1 else "Replicate()",
                                        "Shard(dim=2)"]
    assert got["logits_local"] == [b // data, 1, cfg.padded_vocab // model_axis]


@pytest.mark.parametrize("data,model_axis", SERVE_MESHES)
def test_serve_step_gathers_no_cache_and_no_split_weight(serve_runs, data, model_axis):
    """No step calls `full_tensor()` or moves a placement (no cache and no
    weight is gathered), and every case's all-gathers (the tokens'
    q, k and v, the MoE block's input, the SSM's projections) move less
    than a tenth of the bytes of the weights split over `model`."""
    for case, got in serve_runs["port"][data, model_axis].items():
        assert got["moved"] == [], case
        steps_ = serve_runs["cases"][case]["tokens"].shape[1]
        assert 0 < got["all_gather_bytes"] / steps_ < got["split_weight_bytes"] / 10, case


def test_moe_decode_cases_tell_the_groupings_apart(serve_runs):
    """The MoE case is sensitive to the grouping: its decode with each
    rank's half of the batch grouped alone differs from the global
    groups' (which the sharded step matches), and the global groups
    drop assignments at capacity."""
    grouped = serve_runs["grouped"]
    local = torch.cat([grouped["first"], grouped["second"]], dim=1)
    assert (local - grouped["global"]).abs().max() > 1e-3
    assert sum(serve_runs["drops"]) > 0, serve_runs["drops"]
