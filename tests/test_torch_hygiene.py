"""Import hygiene and device discipline of the PyTorch port.

`repro_torch` and `chip_smoke.py` must import neither JAX nor anything
of the `repro` package; the port's entry points run on CUDA unless asked
for the CPU, and without a GPU they raise instead of carrying on.  Test
workers under xdist share the cores (the root `conftest.py`).
"""
import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.fleet import FleetService, ShardedFleetService  # noqa: E402
from repro_torch.incidents import IncidentEngine  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.frontier import fused  # noqa: E402
from repro_torch.kernels.frontier.ops import CSRC, NVCC_FLAGS  # noqa: E402
from repro_torch.kernels.frontier import frontier as kernels  # noqa: E402
from repro_torch.kernels.frontier import incidents as coactivation  # noqa: E402
from repro_torch.launch import replay, serve, serve_fleet, train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.replay import generate_trace, parse_trace, replay_trace  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(m.name)
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "repro"
    or m.startswith("repro.")
)
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    env.update(extra)
    return env


def test_port_imports_no_jax_and_no_reference_package():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for name in ("repro_torch.fleet.service", "repro_torch.fleet.shard",
                 "repro_torch.kernels.frontier.fused",
                 "repro_torch.launch.serve_fleet", "repro_torch.telemetry.packets",
                 "repro_torch.kernels.frontier.incidents",
                 "repro_torch.incidents", "repro_torch.incidents.engine",
                 "repro_torch.incidents.escalation",
                 "repro_torch.incidents.topology",
                 "repro_torch.kernels.frontier.frontier",
                 "repro_torch.kernels.frontier.ref",
                 "repro_torch.kernels._lib",
                 "repro_torch.kernels.attention",
                 "repro_torch.kernels.attention.causal",
                 "repro_torch.kernels.ssd", "repro_torch.kernels.ssd.scan",
                 "repro_torch.replay", "repro_torch.replay.engine",
                 "repro_torch.replay.trace", "repro_torch.launch.replay",
                 "repro_torch.telemetry.collector",
                 "repro_torch.telemetry.device_events",
                 "repro_torch.telemetry.gather",
                 "repro_torch.distributed.policy", "repro_torch.configs",
                 "repro_torch.configs.paper_gpt", "repro_torch.models.layers",
                 "repro_torch.models.attention",
                 "repro_torch.models.transformer",
                 "repro_torch.models.model_zoo", "repro_torch.models.moe",
                 "repro_torch.models.ssm", "repro_torch.launch.serve",
                 "repro_torch.optim.adamw",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint.ckpt",
                 "repro_torch.launch.steps", "repro_torch.launch.train",
                 "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
                 "repro_torch.distributed.compression",
                 "repro_torch.examples.hidden_rank_demo",
                 "repro_torch.examples.whatif_demo",
                 "repro_torch.examples.fleet_monitor",
                 "repro_torch.examples.serve_demo",
                 "repro_torch.examples.quickstart",
                 "repro_torch.analysis", "repro_torch.analysis.roofline",
                 "repro_torch.analysis.report", "repro_torch.analysis.merge_runs",
                 "repro_torch.launch.dryrun"):
        assert name in out["modules"]


def test_train_driver_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    """`python -m repro_torch.launch.train` runs on the card unless asked
    for the CPU; without one it raises before building anything."""
    args = train.make_argparser().parse_args(["--reduced", "--steps", "2"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config("paper-gpt-125m").reduced()).init()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "2"],
        capture_output=True, text=True, env=_env(CUDA_VISIBLE_DEVICES=""),
        cwd=ROOT, timeout=300,
    )
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert '"first_loss"' not in proc.stdout


def test_serve_driver_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    """`python -m repro_torch.launch.serve` runs on the card unless asked
    for the CPU; without one it raises before building anything, as does
    every family's model."""
    args = serve.make_argparser().parse_args(["--reduced"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(args)
    for arch in ("hymba-1.5b", "mamba2-130m", "phi3.5-moe-42b-a6.6b", "internvl2-1b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(get_config(arch).reduced()).init()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--batch", "2", "--prompt-len", "8", "--decode", "8"],
        capture_output=True, text=True, env=_env(CUDA_VISIBLE_DEVICES=""),
        cwd=ROOT, timeout=300,
    )
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert '"decoded"' not in proc.stdout


def test_service_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetService()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_fleet.run(serve_fleet.make_argparser().parse_args(["--jobs", "2"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.fused_fleet_tick(torch.ones(1, 2, 3, 4).numpy())


def test_sharded_service_without_gpu_raises(monkeypatch):
    """No shard falls back to the CPU: `device="cuda"` (the default)
    raises without a card, through both drivers too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedFleetService(shards=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedFleetService(shards=3, devices=None, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_fleet.run(serve_fleet.make_argparser().parse_args(
            ["--jobs", "2", "--shards", "3"]
        ))
    with pytest.raises(RuntimeError, match="CUDA"):
        replay.run(replay.make_argparser().parse_args(
            ["--synth", "--jobs", "2", "--ticks", "2", "--shards", "3"]
        ))


def test_incident_engine_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        IncidentEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        IncidentEngine(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_fleet.run(serve_fleet.make_argparser().parse_args(
            ["--jobs", "2", "--topology", "fabric"]
        ))
    assert IncidentEngine(device="cpu").device.type == "cpu"


def test_cpu_fabric_run_leaves_coactivation_launches_at_zero(monkeypatch):
    monkeypatch.setattr(coactivation, "launches", 0)
    monkeypatch.setattr(fused, "launches", 0)
    out = serve_fleet.run(serve_fleet.make_argparser().parse_args(
        ["--jobs", "6", "--ranks", "4", "--window", "5", "--rounds", "2",
         "--topology", "fabric", "--device", "cpu"]
    ))
    assert any(r["scope"] == "fleet" for r in out["incidents"])
    assert coactivation.launches == 0
    assert fused.launches == 0


def test_cpu_path_leaves_launches_at_zero(monkeypatch):
    monkeypatch.setattr(fused, "launches", 0)
    service = FleetService(device="cpu")
    assert service.device.type == "cpu"
    fused.fused_fleet_tick(torch.rand(2, 3, 4, 5), device="cpu")
    assert fused.launches == 0


def test_replay_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = parse_trace(generate_trace(jobs=2, ticks=2, world_size=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_trace(trace)
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_trace(trace, device="cuda", fused=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        replay.run(replay.make_argparser().parse_args(
            ["--synth", "--jobs", "2", "--ticks", "2", "--device", "cuda"]
        ))
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.four_dispatch_tick(torch.ones(1, 2, 3, 4).numpy())


def test_cpu_four_dispatch_leaves_every_launch_count_at_zero(monkeypatch):
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
    monkeypatch.setattr(coactivation, "launches", 0)
    monkeypatch.setattr(fused, "launches", 0)
    d = torch.rand(2, 3, 4, 6)
    fused.four_dispatch_tick(d, sync_stages=(2,), host_index=torch.zeros(2, 4),
                             num_hosts=1, device="cpu")
    out = replay.run(replay.make_argparser().parse_args(
        ["--synth", "--jobs", "4", "--ticks", "3", "--ranks", "4",
         "--window", "5", "--incidents", "--shared-switch",
         "--tick-path", "four-dispatch", "--device", "cpu"]
    ))
    assert out["windows_replayed"] > 0
    assert set(kernels.launches.values()) == {0}
    assert coactivation.launches == 0
    assert fused.launches == 0


def test_library_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a header under csrc/ must key a new library: a stale
    one would otherwise load."""
    real = _lib.kernel_source("fused_tick.cu", CSRC).parent
    assert (real / "frontier_common.cuh").is_file()
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("constexpr int kA = 1;\n")
    monkeypatch.setattr(_lib, "build_dir", lambda: tmp_path / "build")
    before = _lib._library_path(tmp_path / "k.cu", NVCC_FLAGS)
    header.write_text("constexpr int kA = 2;\n")
    assert _lib._library_path(tmp_path / "k.cu", NVCC_FLAGS) != before


def test_fused_and_whatif_kernels_share_the_cell_walk():
    """The fused tick and the four-dispatch what-if kernel must agree bit
    for bit, so both build the one cell walk rather than copies of it."""
    for name in ("fused_tick.cu", "whatif_matrix.cu"):
        text = _lib.kernel_source(name, CSRC).read_text()
        assert '#include "cell_walk.cuh"' in text, name
        assert "cell_warp_kernel" not in text and "cell_slab_kernel" not in text, name


def test_regime_kernel_runs_the_cell_walk():
    """The regime kernel takes its statistics from the cell walk's one
    fold (`CellState`) with the what-if family off, so both routes share
    it: no kernel and no step loop of its own."""
    text = _lib.kernel_source("regime_stats.cu", CSRC).read_text()
    assert '#include "cell_walk.cuh"' in text
    assert "launch_cell_walk<false, true, false>" in text
    assert "__global__" not in text and "for (int n" not in text


def test_cell_walk_and_coactivation_refuse_no_size():
    """No launch path refuses a stage or job count: neither source
    returns cudaErrorInvalidValue, the error of the former shared-memory
    limits (about 2,400 stages, about 14,500 jobs a call)."""
    for name in ("cell_walk.cuh", "coactivation.cu"):
        assert "cudaErrorInvalidValue" not in _lib.kernel_source(name, CSRC).read_text(), name


def test_cell_walk_wrappers_take_scratch_from_the_library():
    """Past 32 stages the what-if walk writes segment sums to a scratch
    buffer the wrapper allocates: both wrappers ask the library for its
    size and pass it (the what-if launch's ninth pointer)."""
    pointer, integer = ctypes.c_void_p, ctypes.c_int
    lib = types.SimpleNamespace(**{
        name: types.SimpleNamespace() for name in (
            "whatif_matrix_launch", "whatif_matrix_scratch_floats",
            "whatif_matrix_error_string", "fused_tick_launch",
            "fused_tick_num_slots", "fused_tick_scratch_floats",
            "fused_tick_error_string",
        )
    })
    kernels._bind_whatif(lib)
    fused._bind(lib)
    assert lib.whatif_matrix_launch.argtypes[:10] == [pointer] * 10
    for name in ("whatif_matrix_scratch_floats", "fused_tick_scratch_floats"):
        assert getattr(lib, name).argtypes == [integer] * 4
        assert getattr(lib, name).restype is ctypes.c_longlong
    for name in ("fused_tick.cu", "whatif_matrix.cu"):
        assert "cell_scratch_floats(J, N, R, S)" in _lib.kernel_source(name, CSRC).read_text()


def test_frontier_kernel_takes_its_prefix_from_the_shared_header():
    """The four-dispatch frontier kernel must add its stage prefixes in the
    fused route's order, so it takes them from `frontier_common.cuh`
    (the warp fold's shuffle chain, the rank tiles' `StagePrefix`) and
    keeps no copy of its own."""
    text = _lib.kernel_source("frontier_window.cu", CSRC).read_text()
    assert '#include "frontier_common.cuh"' in text
    assert "warp_stage_prefix(" in text and "StagePrefix pfx" in text
    common = _lib.kernel_source("frontier_common.cuh", CSRC).read_text()
    for name in ("struct StagePrefix", "void warp_stage_prefix"):
        assert name in common and name not in text, name


def test_coactivation_interface_has_no_scratch():
    """`coact_launch` takes the activity tensor, the three outputs and the
    shape: no scratch buffer to allocate or zero."""
    lib = types.SimpleNamespace(coact_launch=types.SimpleNamespace(),
                                coact_error_string=types.SimpleNamespace())
    coactivation._bind(lib)
    pointer, integer = ctypes.c_void_p, ctypes.c_int
    # act; jobs, coact, active; J, N, C, S; the stream
    assert lib.coact_launch.argtypes == [pointer] * 4 + [integer] * 4 + [pointer]
    assert lib.coact_launch.restype is integer


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No CUDA device: non-zero exit and no result line."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=_env(CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    """chip_smoke.py alone in a directory: non-zero exit, no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# -- the test processes' thread budget (the root conftest.py) ----------------

_THREAD_PROBE = """
import os, subprocess, sys
import torch

def test_worker_and_its_child_take_their_share():
    share = max(1, len(os.sched_getaffinity(0)) // 2)
    child = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, check=True)
    assert (torch.get_num_threads(), int(child.stdout)) == (share, share)
"""


def test_xdist_workers_and_their_children_share_the_cores(tmp_path):
    """Under `pytest -n 2` a worker's torch, and a process it starts, run
    on half the cores: the rule of the repo's root conftest.py, here the
    rootdir conftest of a probe's own run, whatever this process set."""
    shutil.copy(ROOT / "conftest.py", tmp_path / "conftest.py")
    (tmp_path / "test_probe.py").write_text(_THREAD_PROBE)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_XDIST_")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "xdist",
         "-n", "2", "test_probe.py"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- thread safety: the sharded service's lanes load and launch at once ------


def _in_threads(fn, n=8):
    """Run `fn(k)` on `n` threads at once with a short switch interval;
    every thread must finish."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fn, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_concurrent_load_builds_and_binds_once(monkeypatch):
    """Eight threads asking for one library at once: one build, one
    `CDLL`, one bind, and every thread gets the same library."""
    calls = {"build": 0, "cdll": 0, "bind": 0}

    def slow_build(name, csrc, flags):
        calls["build"] += 1
        time.sleep(0.05)
        return pathlib.Path("/nonexistent") / f"lib{name}.so"

    def fake_cdll(path):
        calls["cdll"] += 1
        return types.SimpleNamespace(path=path)

    def bind(lib):
        calls["bind"] += 1
        time.sleep(0.01)

    monkeypatch.setattr(_lib, "_loaded", {})
    monkeypatch.setattr(_lib, "build", slow_build)
    monkeypatch.setattr(_lib.ctypes, "CDLL", fake_cdll)
    got = [None] * 8

    def load(k):
        got[k] = _lib.load_library("fused_tick.cu", bind, CSRC, NVCC_FLAGS)

    _in_threads(load)
    assert calls == {"build": 1, "cdll": 1, "bind": 1}
    assert all(lib is got[0] for lib in got)


def test_concurrent_builds_use_their_own_temporary_files(tmp_path, monkeypatch):
    """Two threads of one process building one source at once: distinct
    temporary outputs (threads share a pid), one whole library left, no
    temporary file behind."""
    body = b"x" * 4096
    targets = []

    def slow_nvcc(cmd, **kw):
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        targets.append(out.name)
        with open(out, "wb") as f:
            for i in range(0, len(body), 512):
                f.write(body[i:i + 512])
                f.flush()
                time.sleep(0.005)
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas", stderr="")

    monkeypatch.setattr(_lib, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_lib, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_lib.subprocess, "run", slow_nvcc)
    paths = [None, None]

    def build(k):
        paths[k] = _lib.build("coactivation.cu", CSRC, NVCC_FLAGS)

    _in_threads(build, n=2)
    assert len(targets) == 2 and targets[0] != targets[1]
    assert paths[0] == paths[1] and paths[0].read_bytes() == body
    assert not list(tmp_path.glob("*.tmp.so"))


class _RecordingLock:
    """A lock that counts how often it was taken."""

    def __init__(self):
        self._lock = threading.Lock()
        self.taken = 0

    def __enter__(self):
        self._lock.acquire()
        self.taken += 1

    def __exit__(self, *exc):
        self._lock.release()


def test_launch_counts_lose_nothing_across_threads(monkeypatch):
    """Every wrapper's count is bumped by `_lib.count_launch`, under its
    lock: eight threads adding at once lose no count, and each add took
    the lock."""
    lock = _RecordingLock()
    monkeypatch.setattr(_lib, "_count_lock", lock)
    monkeypatch.setattr(fused, "launches", 0)
    monkeypatch.setattr(coactivation, "launches", 0)
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
    reps = 2000

    def bump(k):
        for _ in range(reps):
            # as the wrappers call it: their globals, or the dict of counts
            _lib.count_launch(vars(fused), "launches")
            _lib.count_launch(vars(coactivation), "launches")
            _lib.count_launch(kernels.launches, "whatif_matrix")

    _in_threads(bump)
    assert fused.launches == coactivation.launches == 8 * reps
    assert kernels.launches == {"frontier_window": 0,
                                "whatif_matrix": 8 * reps, "regime_stats": 0}
    assert lock.taken == 3 * 8 * reps


def test_wrappers_count_through_the_lock():
    """Each CUDA wrapper counts its launch with the shared locked helper,
    never with a bare read-modify-write."""
    import inspect

    for fn in (fused._fused_tick_cuda, coactivation._co_activation_cuda,
               kernels._frontier_cuda, kernels._whatif_cuda,
               kernels._regime_cuda):
        text = inspect.getsource(fn)
        assert text.count("_lib.count_launch(") == 1, fn.__name__
        assert "launches +=" not in text and "] += 1" not in text, fn.__name__
