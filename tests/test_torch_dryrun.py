"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's,
on the CPU.

- Rows against the reference: both CLIs in subprocesses (the reference
  sets ``XLA_FLAGS`` at import) on qwen1.5-0.5b train_4k (one microbatch:
  eager fake dispatch of four takes ~2.5 min on a CPU), mamba2-130m decode_32k
  on both meshes, phi3.5-moe decode_32k and the skipped paper-gpt-125m
  long_500k.  Equal: the keys, `n_chips`, `plan`, `accum`, the flags and
  `model_flops_global`; `args_bytes` equal but for the leaves named in
  `_ARG_LEAVES`.  FLOPs, bytes and collectives are recorded beside the
  reference's, not held equal: the programs differ.
- Per-device counts on a fake (16, 16) mesh, exact: under `DP_ALL_PLAN`
  x 256 the one-device step's at the same global batch, under
  `BASELINE_PLAN` (weights gathered, whole-weight compute) the one-device
  step's at batch B / 16; `args_bytes` against the local shards summed
  from `tree_shardings`; a dense config, and a MoE one under
  `BASELINE_PLAN` (under `DP_ALL_PLAN` its one-device step would run 256
  dispatch groups a layer).
- No process group is left after `run_cell`, also after one that raised;
  a group already up is refused; ``cuda`` without a card raises.
- `report`'s tables and `merge_runs` on the reference's own rows.
"""
import importlib
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402

from repro_torch.analysis import merge_runs, report  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ref_report = importlib.import_module("repro.analysis.report")
ref_merge = importlib.import_module("repro.analysis.merge_runs")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (arch, shape, mesh, extra flags): one CLI call each, in both packages
CELLS = [
    ("qwen1.5-0.5b", "train_4k", "single", ["--accum", "1"]),
    ("mamba2-130m", "decode_32k", "both", []),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "single", []),
    ("paper-gpt-125m", "long_500k", "single", ["--skip-production"]),
]
OK_ROWS = [("single", "qwen1.5-0.5b", "train_4k"), ("single", "mamba2-130m", "decode_32k"),
           ("multi", "mamba2-130m", "decode_32k"),
           ("single", "phi3.5-moe-42b-a6.6b", "decode_32k")]
#: bytes the reference's arguments hold that the port's do not: the
#: decode index, a Python int in the port and an int32 in the reference
#: where the step reads it (the reference's jit drops an unused argument,
#: as it does mamba2's index)
_ARG_LEAVES = {("single", "phi3.5-moe-42b-a6.6b", "decode_32k"): {"index": 4}}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """Both CLIs on `CELLS`, all calls at once: {"ref"|"port": {(mesh,
    arch, shape): row}} and the two output directories."""
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("ref", "port")}
    procs = []
    for arch, shape, mesh, extra in CELLS:
        for pkg in ("ref", "port"):
            argv = [sys.executable, "-m",
                    "repro.launch.dryrun" if pkg == "ref" else "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--mesh", mesh,
                    "--out", str(dirs[pkg])] + extra
            if pkg == "port":
                argv += ["--device", "cpu"]
            procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True, env=_env(),
                                          cwd=ROOT))
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for pkg, d in dirs.items():
        out[pkg] = {}
        for name in os.listdir(d):
            with open(d / name) as f:
                row = json.load(f)
            out[pkg][(row["mesh"], row["arch"], row["shape"])] = row
    out["dirs"] = dirs
    return out


def test_skipped_cell_cli_writes_the_references_row(rows):
    key = ("single", "paper-gpt-125m", "long_500k")
    got, want = dict(rows["port"][key]), dict(rows["ref"][key])
    assert got["status"] == "skipped" and got["reason"]
    got.pop("wall_s"), want.pop("wall_s")
    assert got == want


@pytest.mark.parametrize("key", OK_ROWS, ids=["__".join(k) for k in OK_ROWS])
def test_rows_equal_the_reference(rows, key):
    got, want = rows["port"][key], rows["ref"][key]
    assert got["status"] == want["status"] == "ok"
    assert sorted(got) == sorted(want)
    for part in ("memory", "costs", "scan_graph_costs", "roofline"):
        assert sorted(got[part]) == sorted(want[part]), part
    for k in ("n_chips", "plan", "accum", "zero1", "triangular", "attn_bf16"):
        assert got[k] == want[k], k
    assert got["roofline"]["model_flops_global"] == want["roofline"]["model_flops_global"]
    missing = sum(_ARG_LEAVES.get(key, {}).values())
    assert got["memory"]["args_bytes"] + missing == want["memory"]["args_bytes"]
    assert got["costs"] == got["scan_graph_costs"]
    assert set(got["costs"]["coll_by_kind"]) == set(want["costs"]["coll_by_kind"])
    assert got["costs"]["flops"] > 0 and got["costs"]["bytes_accessed"] > 0


def test_record_the_tensor_parallel_gap(rows):
    """The port's per-device terms beside the reference's (pytest -s
    prints them): with every weight gathered, the train cell's per-device
    FLOPs are the whole weights' on this rank's batch shard, ~16x the
    reference's Megatron step on (16, 16)."""
    for key in OK_ROWS:
        got, want = rows["port"][key], rows["ref"][key]
        g, w = got["costs"], want["costs"]
        ratio = g["flops"] / w["flops"]
        print(f"{'/'.join(key)}: flops {g['flops']:.4e} / {w['flops']:.4e} = {ratio:.2f}; "
              f"args {got['memory']['args_bytes']} / {want['memory']['args_bytes']}; "
              f"temp {got['memory']['temp_bytes']} / {want['memory']['temp_bytes']}; "
              f"coll {g['coll_bytes']:.4e} / {w['coll_bytes']:.4e}; "
              f"dominant {got['roofline']['dominant']} / {want['roofline']['dominant']}")
    train = ("single", "qwen1.5-0.5b", "train_4k")
    ratio = rows["port"][train]["costs"]["flops"] / rows["ref"][train]["costs"]["flops"]
    assert 8 < ratio < 32


# -- the tables, on the reference's rows ---------------------------------------


def _tables(mod, rows_):
    return [mod.dryrun_table(rows_, m) for m in ("single", "multi")] + [
        mod.roofline_table(rows_, m) for m in ("single", "multi")]


def test_report_tables_equal_the_references(rows):
    ref_rows = ref_report.load_rows(str(rows["dirs"]["ref"]))
    assert ref_rows == report.load_rows(str(rows["dirs"]["ref"]))
    for got, want in zip(_tables(report, ref_rows), _tables(ref_report, ref_rows)):
        got, want = got.splitlines(), want.splitlines()
        assert len(got) == len(want)
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if got[0].startswith("### Roofline"):
            assert diff == [0] and "H100 SXM: 989 TF bf16 / 3.35 TB/s HBM / 50 GB/s" in got[0]
        else:
            assert diff == []
    # the port's own rows render too
    assert "qwen1.5-0.5b" in report.roofline_table(
        report.load_rows(str(rows["dirs"]["port"])), "single")


def test_merge_runs_writes_the_same_files(rows, tmp_path, monkeypatch):
    """A tagged delta run grafted onto full rows: the port's CLI writes
    the files the reference's writes."""
    out = {}
    for name, mod in (("ref", ref_merge), ("port", merge_runs)):
        full, delta = tmp_path / name / "full", tmp_path / name / "delta"
        shutil.copytree(rows["dirs"]["port"], full)
        delta.mkdir()
        for src in sorted(rows["dirs"]["ref"].iterdir()):
            shutil.copy(src, delta / f"delta_{src.name}")
        monkeypatch.setattr(sys, "argv", ["merge_runs", "--full", str(full), "--delta",
                                          str(delta), "--tag", "delta"])
        mod.main()
        out[name] = {p.name: p.read_text() for p in sorted(full.iterdir())}
    assert out["port"] == out["ref"] and len(out["port"]) == 5


# -- per-device counting on a fake (16, 16) mesh ----------------------------------


def _one_device(cfg, shape, plan, accum):
    mesh = port_mesh.make_local_mesh(device="cpu")
    return dryrun.measure_cell(cfg, shape, mesh, plan, "cpu", accum=accum)


def _on_production_mesh(cfg, shape, plan, accum):
    with dryrun.fake_group():
        mesh = port_mesh.make_production_mesh(device_type="cpu")
        return dryrun.measure_cell(cfg, shape, mesh, plan, "cpu", accum=accum)


def _local_bytes(sh, spec, dtype=None):
    n = 1
    for dim, size in zip(tuple(sh.spec) + (None,) * spec.dim(), spec.shape):
        div = 1
        for a in (() if dim is None else (dim,) if isinstance(dim, str) else dim):
            div *= sharding.axis_size(sh.mesh, a)
        assert size % div == 0
        n *= size // div
    return n * (dtype or spec.dtype).itemsize


def test_dp_all_per_device_flops_are_the_one_device_steps_over_256():
    cfg = get_config("paper-gpt-125m").reduced()
    shape = ShapeConfig("t", 64, 256, "train")
    got = _on_production_mesh(cfg, shape, sharding.DP_ALL_PLAN, 1)
    one = _one_device(cfg, shape, sharding.DP_ALL_PLAN, 1)
    assert got["costs"].flops * 256 == one["costs"].flops


@pytest.mark.parametrize("arch", ["paper-gpt-125m", "phi3.5-moe-42b-a6.6b"])
def test_baseline_per_device_flops_are_the_one_device_steps_at_b_over_16(arch):
    """Held by placement only: each rank computes its 16 rows on the
    gathered weights, four microbatches of 4."""
    cfg = get_config(arch).reduced()
    got = _on_production_mesh(cfg, ShapeConfig("t", 64, 256, "train"),
                              sharding.BASELINE_PLAN, 4)
    one = _one_device(cfg, ShapeConfig("t", 64, 16, "train"), sharding.BASELINE_PLAN, 4)
    assert got["costs"].flops == one["costs"].flops
    # every weight gathered each step
    assert got["costs"].coll_counts["all-gather"] > 0


@pytest.mark.parametrize("plan,accum", [("BASELINE_PLAN", 4), ("DP_ALL_PLAN", 1)])
def test_args_bytes_are_the_local_shards(plan, accum):
    """Parameters, ZeRO-1 moments, count and step, and the batch, each
    leaf's shard summed from its spec; every one but the count, the step
    and the batch is updated in place."""
    cfg = get_config("paper-gpt-125m").reduced()
    model = build_model(cfg)
    shape = ShapeConfig("t", 64, 256, "train")
    plan = getattr(sharding, plan)
    got = _on_production_mesh(cfg, shape, plan, accum)
    with dryrun.fake_group():
        mesh = port_mesh.make_production_mesh(device_type="cpu")
        plan = dryrun._plan_for(cfg, shape, mesh, plan)
        specs = steps.param_specs(model)
        params = sharding.tree_shardings(mesh, model.param_axes(), plan, specs)
        _, state_sh = steps.build_train_step(model, mesh, plan)
        state = sum(_local_bytes(params[n], s) for n, s in specs.items())
        state += 2 * sum(_local_bytes(state_sh.moments[n], s, torch.float32)
                         for n, s in specs.items())
        tokens = torch.empty((256, 64), dtype=torch.int32, device="meta")
        batch = 2 * _local_bytes(sharding.batch_sharding(mesh, 2, plan), tokens)
    assert got["memory"]["args_bytes"] == state + 2 * 4 + batch  # + count, step
    assert got["memory"]["alias_bytes"] == state


# -- the process group and the device ---------------------------------------------


def test_no_group_is_left_after_a_cell():
    assert not dist.is_initialized()
    row = dryrun.run_cell("mamba2-130m", "decode_32k", "multi", device="cpu")
    assert row["status"] == "ok" and row["n_chips"] == 512
    assert not dist.is_initialized()


def test_no_group_is_left_after_a_cell_that_raised(monkeypatch):
    def boom(*args, **kwargs):
        assert dist.is_initialized() and dist.get_world_size() == dryrun.WORLD
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "measure_cell", boom)
    with pytest.raises(RuntimeError, match="boom"):
        dryrun.run_cell("paper-gpt-125m", "train_4k", "single", device="cpu")
    assert not dist.is_initialized()


def test_a_group_already_up_is_refused():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            dryrun.run_cell("paper-gpt-125m", "train_4k", "single", device="cpu")
    finally:
        dist.destroy_process_group()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_cell("paper-gpt-125m", "train_4k", "single")
    assert not dist.is_initialized()
    # a skipped cell is decided before any device or group
    assert dryrun.run_cell("paper-gpt-125m", "long_500k", "single")["status"] == "skipped"


def test_flags_and_plans_are_the_references():
    assert sorted(dryrun.PLANS) == ["baseline", "decode", "dp_all", "dp_fsdp"]
    assert dryrun.TRAIN_ACCUM == 4
    cfg = get_config("qwen1.5-0.5b")
    with dryrun.fake_group():
        mesh = port_mesh.make_production_mesh(device_type="cpu")
        plan = dryrun._plan_for(cfg, ShapeConfig("d", 32768, 128, "decode"), mesh,
                                sharding.DECODE_PLAN)
        assert plan.batch_axes == ("data",)
        assert plan.rules["kv_heads"] == "model"  # 16 KV heads divide 16
        one = dryrun._plan_for(cfg, ShapeConfig("d", 32768, 1, "decode"), mesh,
                               sharding.DECODE_PLAN)
        assert one.batch_axes == ()
        gqa = dryrun._plan_for(get_config("phi3.5-moe-42b-a6.6b"),
                               ShapeConfig("d", 32768, 128, "decode"), mesh,
                               sharding.DECODE_PLAN)
        assert gqa.rules["kv_heads"] is None  # 8 KV heads do not divide 16
