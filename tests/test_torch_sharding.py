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
"""
import dataclasses
import json
import os
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


@pytest.mark.parametrize("plan", ["BASELINE_PLAN", "DP_ALL_PLAN"])
@pytest.mark.parametrize("arch", ["paper-gpt-125m", "phi3.5-moe-42b-a6.6b",
                                  "whisper-base"])
def test_zero1_moments_equal_the_reference(fake_group, arch, plan):
    """Each moment's spec is the reference's, its stacked "layer" dim
    dropped.  Where the reference's ZeRO-1 put ``data`` on that layer dim
    (n_layers a multiple of 16: phi3.5-moe's 32), the port's per-layer
    leaf takes ``data`` on the first of its own dims that 16 divides, as
    the same rule on the per-layer shape does (`ROADMAP.md` §C14)."""
    port_m, ref_m = _meshes("16x16")
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
    for name, sh in state_sh.moments.items():
        head, *rest = name.split(".")
        stacked = head in LAYER_STACKS
        key = ".".join([head] + rest[1:]) if stacked else name
        got = _padded(sh.spec, specs[name].dim())
        want = _padded(ref_mu[key], len(rspec[key]))
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
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
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
uneven_error = None
if "uneven_batch" in case:  # each rank's tokens no whole number of groups
    try:
        step(state, case["uneven_batch"])
    except ValueError as e:
        uneven_error = str(e)
if rank == 0:
    torch.save(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                    params=params, mu=moments, placements=before, mu_placements=mu,
                    mu_local=local, step=int(state.step), prefill=logits,
                    decode=torch.stack(decoded), cache_placements=cache_pl,
                    uneven_error=uneven_error,
                    accum=dict(loss=float(am["loss"]), grad_norm=float(am["grad_norm"]),
                               params=accum_params)), out_path)
print(json.dumps({"rank": rank, "ok": True}), flush=True)
dist.destroy_process_group()
"""

_OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10)


def _gloo_step(tmp_path, case_path, plan, data, model_axis):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    init = f"file://{tmp_path / f'gloo_{plan}'}"
    out = tmp_path / f"{plan}.pt"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init, str(case_path), plan, str(data),
         str(model_axis), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    deadline = time.monotonic() + 240
    try:
        for p in procs:
            _, stderr = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, stderr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
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
    `_close_params` holds them (the data-parallel sum adds the two
    halves' gradients in another order than the one-device step); under
    BASELINE_PLAN on (1, 2) both ranks compute the whole batch on the
    gathered weights, so the step is the one-device step bit for bit."""
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
    # the decode gathers the caches and weights and runs the whole batch:
    # the one-device decode bit for bit; the prefill of a batch split
    # over `data` runs two half-batch products, so within 1e-5
    assert torch.equal(got["decode"], one["decode"])
    torch.testing.assert_close(got["prefill"], one["prefill"], rtol=1e-5, atol=1e-5)
    if plan == "BASELINE_PLAN":
        assert torch.equal(got["prefill"], one["prefill"])
        # DECODE_PLAN on (1, 2): the cache sequence over `model`
        assert got["cache_placements"]["k"] == ["Replicate()", "Shard(dim=2)"]
        for name, p in one["params"].items():
            assert torch.equal(got["params"][name], p), name
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
    dispatch groups, so the step is the one-device step within the
    tolerances of the dense case; a batch whose rank shards are no whole
    number of groups raises."""
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
    assert torch.equal(got["decode"], one["decode"])
    torch.testing.assert_close(got["prefill"], one["prefill"], rtol=1e-5, atol=1e-5)
    assert "whole number of dispatch groups of 64" in got["uneven_error"]
    assert "(96)" in got["uneven_error"]
