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
- Per-device counts on a fake (16, 16) mesh: under `DP_ALL_PLAN` x 256
  the one-device step's at the same global batch, exactly; under
  `BASELINE_PLAN` (tensor-parallel compute, full widths cut to 2 layers)
  x 16 the one-device step's at batch B / 16, exactly for the dense
  config and with the replicated router and KV products stated for the
  MoE one, no whole model-sharded weight gathered; `args_bytes` against
  the local shards summed from `tree_shardings`.
- No process group is left after `run_cell`, also after one that raised;
  a group already up is refused; ``cuda`` without a card raises.
- `report`'s tables and `merge_runs` on the reference's own rows.
"""
import dataclasses
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
    ("mamba2-130m", "prefill_32k", "single", []),
    ("whisper-base", "prefill_32k", "multi", []),
]
OK_ROWS = [("single", "qwen1.5-0.5b", "train_4k"), ("single", "mamba2-130m", "decode_32k"),
           ("multi", "mamba2-130m", "decode_32k"),
           ("single", "phi3.5-moe-42b-a6.6b", "decode_32k"),
           ("single", "mamba2-130m", "prefill_32k"), ("multi", "whisper-base", "prefill_32k")]
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


#: all-gather bytes a device of the qwen1.5-0.5b train_4k step on (16, 16)
#: at one microbatch when the step gathered every weight at use (the
#: port's CLI on the CPU, before tensor-parallel compute)
GATHERED_WEIGHTS_ALL_GATHER = 985_958_400


def test_record_the_tensor_parallel_gap(rows):
    """The port's per-device terms beside the reference's (pytest -s
    prints them).  Under BASELINE_PLAN each rank computes on its shards
    of the weights, as the reference's Megatron step: the train cell's
    per-device FLOPs are within 0.75-1.25x the reference's, and its
    all-gather bytes at least 4x below the gathered-weights step's.
    Under DECODE_PLAN each rank decodes its batch rows against its
    slices of the caches on its shards of the weights: phi3.5-moe's
    decode_32k temp bytes fit 80 GiB a device and its all-gathers move
    under 1e9 bytes (the gathered step's: 1.1167e12 and 6.7235e11), and
    mamba2-130m's decode_32k runs at most 2x the reference's per-device
    FLOPs on both meshes (the gathered step's: 93.91x and 121.17x).
    Under BASELINE_PLAN with the SSD scan on each rank's slice of
    d_inner, mamba2-130m's prefill_32k runs at most 2x the reference's
    per-device FLOPs (the whole scan's: 7.79x); with the attention split
    over query blocks (one row a rank; 8 heads and 1 x 8 KV groups do not
    divide 16), whisper-base's prefill_32k on (2, 16, 16) at most 2x (the
    whole attention's: 12.78x) and under the reference's total bytes a
    device (the whole attention's: 16.306 GiB against 2.49)."""
    for key in OK_ROWS:
        got, want = rows["port"][key], rows["ref"][key]
        g, w = got["costs"], want["costs"]
        ratio = g["flops"] / w["flops"]
        print(f"{'/'.join(key)}: flops {g['flops']:.4e} / {w['flops']:.4e} = {ratio:.2f}; "
              f"args {got['memory']['args_bytes']} / {want['memory']['args_bytes']}; "
              f"temp {got['memory']['temp_bytes']} / {want['memory']['temp_bytes']}; "
              f"all-gather {g['coll_by_kind']['all-gather']:.4e} / "
              f"{w['coll_by_kind']['all-gather']:.4e}; "
              f"all-reduce {g['coll_by_kind']['all-reduce']:.4e} / "
              f"{w['coll_by_kind']['all-reduce']:.4e}; "
              f"coll {g['coll_bytes']:.4e} / {w['coll_bytes']:.4e}; "
              f"dominant {got['roofline']['dominant']} / {want['roofline']['dominant']}")
    train = ("single", "qwen1.5-0.5b", "train_4k")
    got = rows["port"][train]["costs"]
    ratio = got["flops"] / rows["ref"][train]["costs"]["flops"]
    assert 0.75 <= ratio <= 1.25
    assert 4 * got["coll_by_kind"]["all-gather"] <= GATHERED_WEIGHTS_ALL_GATHER
    moe = rows["port"][("single", "phi3.5-moe-42b-a6.6b", "decode_32k")]
    assert moe["memory"]["temp_bytes"] < 80 * 2**30
    assert moe["costs"]["coll_by_kind"]["all-gather"] < 1e9
    for mesh in ("single", "multi"):
        key = (mesh, "mamba2-130m", "decode_32k")
        assert rows["port"][key]["costs"]["flops"] <= 2 * rows["ref"][key]["costs"]["flops"]
    for key in (("single", "mamba2-130m", "prefill_32k"), ("multi", "whisper-base", "prefill_32k")):
        assert rows["port"][key]["costs"]["flops"] <= 2 * rows["ref"][key]["costs"]["flops"]
    whisper = ("multi", "whisper-base", "prefill_32k")
    assert (rows["port"][whisper]["memory"]["total_per_device_gib"]
            <= rows["ref"][whisper]["memory"]["total_per_device_gib"])


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
    assert out["port"] == out["ref"] and len(out["port"]) == len(OK_ROWS) + 1  # + the skipped row


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


def _router_and_kv_flops(cfg, tokens: int) -> tuple[float, float]:
    """(the router's, the key and value projections') FLOPs of one-device
    train steps over `tokens` tokens under remat: each product is run
    forward twice (the step, the recompute) and twice backward (the
    input's and the weight's gradients), 2 x m x n x k each."""
    per = 4 * 2 * tokens * cfg.n_layers * cfg.d_model
    return float(per * cfg.n_experts), float(2 * per * cfg.kv_dim)


@pytest.mark.parametrize("arch", ["paper-gpt-125m", "phi3.5-moe-42b-a6.6b"])
def test_baseline_per_device_flops_are_the_one_device_steps_at_b_over_16(arch, monkeypatch):
    """Tensor-parallel compute: at full widths cut to 2 layers, on fake
    tensors, each rank's 16 rows (four microbatches of 4) run on its
    shards of the weights, so 16 ranks of `model` together do the
    one-device step's work at batch B / 16.  Dense (paper-gpt-125m: 12
    heads do not divide 16, so the projections are column products
    gathered whole and the attention is split over (batch, kv head)
    groups): x 16 exactly.  MoE (phi3.5-moe at 512 tokens a row, so a
    rank's microbatch is one dispatch group; 8 KV heads, replicated by
    `_plan_for`'s GQA rule): the router's product is replicated (15
    more copies of it), and each rank's two query heads read one KV head
    sliced from the whole ``wk``/``wv``, 1/8 of the one-device
    projections where a 16th would divide (one more copy of them): x 16
    is 1.0284 x the one-device step's.  No
    all-gather over `model` moves a whole model-sharded weight."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    gathers = []

    class Recording(dryrun.OpCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func._overloadpacket.__name__ == "all_gather_into_tensor":
                gathers.append((args[2], out.numel()))
            return out

    seq = cfg.moe_group // 4 if cfg.n_experts else 64  # a rank's microbatch: one group
    shape = ShapeConfig("t", seq, 256, "train")
    with monkeypatch.context() as m:
        m.setattr(dryrun, "OpCounter", Recording)
        with dryrun.fake_group():
            mesh = port_mesh.make_production_mesh(device_type="cpu")
            got = dryrun.measure_cell(cfg, shape, mesh, sharding.BASELINE_PLAN, "cpu",
                                      accum=4)
            model = build_model(cfg)
            specs = steps.param_specs(model)
            plan = dryrun._plan_for(cfg, shape, mesh, sharding.BASELINE_PLAN)
            tp = sharding.tensor_parallel(sharding.tree_shardings(
                mesh, model.param_axes(), plan, specs), plan)
            group = mesh.get_group("model").group_name
    one = _one_device(cfg, ShapeConfig("t", seq, 16, "train"), sharding.BASELINE_PLAN, 4)
    router, kv = _router_and_kv_flops(cfg, 16 * seq)
    if cfg.n_experts:
        assert got["costs"].flops * 16 == pytest.approx(
            one["costs"].flops + 15 * router + kv, rel=1e-9)
        assert got["costs"].flops * 16 / one["costs"].flops == pytest.approx(1.0284, abs=1e-4)
    else:
        assert got["costs"].flops * 16 == one["costs"].flops
    whole = {specs[n].numel() for n in tp.dims}
    assert tp.dims and gathers
    assert not [n for g, n in gathers if g == group and n in whole]
@pytest.mark.parametrize("arch,multi,rows", [("mamba2-130m", False, 16),
                                              ("whisper-base", True, 32)])
def test_split_scan_and_query_split_per_device_flops_are_near_the_one_device_over_16(
        arch, multi, rows):
    """Full widths cut to 2 layers, a 4,096 prefill, one row a rank,
    BASELINE_PLAN: mamba2-130m on (16, 16) (24 heads do not divide 16:
    each rank scans its 96 channels of d_inner on the 2 heads they touch,
    B and C whole, and computes the ``in_proj`` columns of its z and x
    channels and its heads' dt, and a 16th of B and C's) and
    whisper-base on (2, 16, 16) (8
    heads and 1 x 8 KV groups do not divide 16: each rank attends with
    its 256 of the 4,096 decoder queries and its 64 of the 1,024 encoder
    frames, k and v whole) do at most 2x the one-device step's work at
    one row, over 16, a device: 1.0320x and exactly 1x (1.0318x before
    the scan took the state entering each chunk as one product over the
    chunks, a product each rank makes for its own heads).  With the whole
    scan and the whole attention, 3.1307x and 4.5294x; with the scan
    split and the projections computed whole and gathered (a 16th of
    the first 3,344 ``in_proj`` columns and all of the last 8 a rank),
    1.0354x."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              n_enc_layers=min(2, get_config(arch).n_enc_layers))
    with dryrun.fake_group():
        mesh = port_mesh.make_production_mesh(multi, device_type="cpu")
        got = dryrun.measure_cell(cfg, ShapeConfig("p", 4096, rows, "prefill"), mesh,
                                  sharding.BASELINE_PLAN, "cpu")
    one = _one_device(cfg, ShapeConfig("p", 4096, 1, "prefill"), sharding.BASELINE_PLAN, 1)
    ratio = got["costs"].flops * 16 / one["costs"].flops
    assert ratio <= 2
    assert ratio == pytest.approx(1.0320 if arch == "mamba2-130m" else 1.0, abs=1e-4)


#: mamba2-130m at full widths cut to 2 layers, a 4,096 prefill at one
#: row a rank on (16, 16) under BASELINE_PLAN, when each layer gathered
#: its whole ``in_proj`` and conv outputs over `model` (the port's counts
#: before the split scan read only its own channels)
WHOLE_SSM_PROJECTIONS = {"all_gather": 113_508_352, "flops": 25_329_401_856}


def test_split_scan_gathers_no_whole_projection():
    """Each rank of the split scan computes the ``in_proj`` columns of its
    own z and x channels and its heads' dt, and a 16th of B and C, then
    gathers B and C alone (and the conv's weights, 4 x 1,792): its
    all-gather bytes fall below the whole projections' at no more
    FLOPs."""
    cfg = dataclasses.replace(get_config("mamba2-130m"), n_layers=2)
    with dryrun.fake_group():
        mesh = port_mesh.make_production_mesh(device_type="cpu")
        got = dryrun.measure_cell(cfg, ShapeConfig("p", 4096, 16, "prefill"), mesh,
                                  sharding.BASELINE_PLAN, "cpu")["costs"]
    assert got.coll_by_kind["all-gather"] < WHOLE_SSM_PROJECTIONS["all_gather"] / 10
    assert got.flops <= WHOLE_SSM_PROJECTIONS["flops"]


#: one train_4k cell of phi3.5-moe at full widths, `n_layers` layers, on
#: the fake (16, 16) or (2, 16, 16) mesh under BASELINE_PLAN, four
#: microbatches: its temp bytes
_MOE_TRAIN_CELL = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as port_mesh

layers, multi = int(sys.argv[1]), sys.argv[2] == "multi"
cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), n_layers=layers)
with dryrun.fake_group():
    mesh = port_mesh.make_production_mesh(multi, device_type="cpu")
    got = dryrun.measure_cell(cfg, SHAPES["train_4k"], mesh, sharding.BASELINE_PLAN, "cpu",
                              accum=dryrun.TRAIN_ACCUM)
print(json.dumps({"temp": got["memory"]["temp_bytes"]}))
"""


@pytest.fixture(scope="module")
def moe_train_temp():
    """{(layers, mesh): temp_bytes} of `_MOE_TRAIN_CELL` at 2 and 4 layers
    on (16, 16) and 2 layers on (2, 16, 16), the three at once."""
    cells = [(2, "single"), (4, "single"), (2, "multi")]
    procs = [subprocess.Popen([sys.executable, "-c", _MOE_TRAIN_CELL, str(n), mesh],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env(), cwd=ROOT) for n, mesh in cells]
    out = {}
    try:
        for cell, p in zip(cells, procs):
            stdout, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
            out[cell] = json.loads(stdout.splitlines()[-1])["temp"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_moe_train_temp_grows_by_less_than_a_gathered_expert_layer(moe_train_temp):
    """Each layer gathers its experts' hidden dim over `data` where it
    reads them and reduce-scatters their gradient, and the gradient sums
    are f32 in the shards' shapes: per added layer, temp grows by what
    the step must keep for it (remat's saved input, a microbatch of 4
    rows x 4,096 x d_model in bf16; the f32 sums of the layer's local
    shards) and by less than one layer's gathered experts a rank
    (3 x d_model x d_ff x 1 expert x 2 B) beyond that.  Gathering every
    expert before the step, the f32 sums in the gathered shape, grew by
    481 MB a layer beyond it (675,856,384 bytes in all)."""
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    model = build_model(dataclasses.replace(cfg, n_layers=1))
    with dryrun.fake_group():
        mesh = port_mesh.make_production_mesh(device_type="cpu")
        plan = dryrun._plan_for(cfg, dryrun.SHAPES["train_4k"], mesh, sharding.BASELINE_PLAN)
        specs = steps.param_specs(model)
        shards = sharding.tree_shardings(mesh, model.param_axes(), plan, specs)
        layer = sum(_local_bytes(shards[n], s, torch.float32)
                    for n, s in specs.items() if n.startswith("layers.0."))
    saved = 4 * 4096 * cfg.d_model * 2
    experts = 3 * cfg.d_model * cfg.d_ff * (cfg.n_experts // 16) * 2
    growth = (moe_train_temp[4, "single"] - moe_train_temp[2, "single"]) / 2
    assert 0 < growth - saved - layer < experts


def test_moe_train_temp_falls_with_a_second_pod(moe_train_temp):
    """The gathered experts no longer fill the temp: a second pod halves
    each rank's rows, and the 2-layer cell's temp falls with them."""
    assert moe_train_temp[2, "multi"] < moe_train_temp[2, "single"]


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
