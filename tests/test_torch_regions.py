"""The train step's device-timed regions (`repro_torch.telemetry.regions`)
on the CPU, where each boundary's host time is its time.

A reduced dense config with layer and query-block remat and a hybrid one:
the regions change no number (losses, first moments and parameters bit
for bit after two steps, also on two Gloo ranks), mark nothing while off,
tile the step exactly, read ``recompute`` only under remat, nest the SSD's
scan inside its mixer, turn on under a profiler with no other call, and
sit on the profiler's clock.  The
event path (a card's) runs on stand-in events: folding never waits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.contract import fused_schema
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticTokens
from repro_torch.distributed.sharding import BASELINE_PLAN
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import build_train_step, init_train_state
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.telemetry import Monitor, SideValues, StageRecorder, regions, timed_regions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
#: (arch, overrides of its reduced config): remat of the layers and of
#: the attention's query blocks (two 16-row blocks of a 32-token row)
CASES = {
    "dense": ("granite-3-2b", dict(remat=True, attn_remat=True)),
    "hybrid": ("hymba-1.5b", dict(remat=True, attn_remat=True)),
}
REGION_NAMES = {"embed", "attention", "mlp", "head_loss", "optimizer"}


def _cfg(arch, **changes):
    changes = dict(dict(attn_q_chunk=16, attn_kv_chunk=16), **changes)
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def _batch(cfg, i, accum=1):
    g = torch.Generator().manual_seed(100 + i)
    shape = (accum, 2, 32) if accum > 1 else (2, 32)
    return {k: torch.randint(0, cfg.vocab_size, shape, generator=g, dtype=torch.int32)
            for k in ("tokens", "labels")}


def _train(cfg, on, steps=2, accum=1):
    """`steps` monitored steps from seed-0 weights, the regions on or off
    (each folded step's intervals kept in ``monitor.regions.log``):
    (losses, state, monitor)."""
    model = build_model(cfg)
    step, _ = build_train_step(model, make_local_mesh(device="cpu"), BASELINE_PLAN,
                               AdamWConfig(**OPT), accum_steps=accum)
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    monitor = Monitor(fused_schema(world_size=1), window_steps=100)
    monitor.regions.log = []
    losses = []
    with timed_regions() if on else contextlib.nullcontext():
        for i in range(steps):
            with monitor.step():
                state, m = step(state, _batch(cfg, i, accum))
            monitor.end_of_step()
            losses.append(float(m["loss"]))
    return losses, state, monitor


def _regions(side) -> dict:
    return {k: v for k, v in side.items() if k.startswith("region.")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_regions_change_no_number(case):
    arch, changes = CASES[case]
    cfg = _cfg(arch, **changes)
    off_losses, off, off_mon = _train(cfg, False)
    on_losses, on, on_mon = _train(cfg, True)
    assert on_losses == off_losses
    off_params, on_params = dict(off.params.named_parameters()), dict(on.params.named_parameters())
    for n in off_params:
        assert torch.equal(on_params[n], off_params[n]), n
        assert torch.equal(on.opt.mu[n], off.opt.mu[n]), n
        assert torch.equal(on.opt.nu[n], off.opt.nu[n]), n
    names = {k.split(".")[1] for r in on_mon.recorder.history for k in _regions(r.side)}
    assert names >= REGION_NAMES | ({"ssm", "ssm_scan"} if case == "hybrid" else set())
    assert all(not _regions(r.side) for r in off_mon.recorder.history)


def test_regions_off_mark_nothing(monkeypatch):
    """Off, no marker runs, no boundary is marked (so no event is taken)
    and no step's side carries a region."""
    calls = {"apply": 0, "mark": 0}
    apply, mark = regions._Boundary.apply, regions.RegionTimer._mark

    def counted_apply(*a):
        calls["apply"] += 1
        return apply(*a)

    def counted_mark(self, x):
        calls["mark"] += 1
        return mark(self, x)

    monkeypatch.setattr(regions._Boundary, "apply", counted_apply)
    monkeypatch.setattr(regions.RegionTimer, "_mark", counted_mark)
    cfg = _cfg("granite-3-2b", **CASES["dense"][1])
    _, _, monitor = _train(cfg, False)
    assert calls == {"apply": 0, "mark": 0}
    assert regions.timer is None
    assert all(not _regions(r.side) for r in monitor.recorder.history)
    _train(cfg, True, steps=1)
    assert calls["apply"] > 0 and calls["mark"] > 0 and regions.timer is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_intervals_tile_the_step(case):
    """Every interval is charged once: the regions' and ``none``'s host
    ns sum to the span from the first boundary to the last, exactly."""
    arch, changes = CASES[case]
    _, _, monitor = _train(_cfg(arch, **changes), True)
    for record in monitor.recorder.history:
        side = _regions(record.side)
        parts = sum(round(v * 1e9) for k, v in side.items() if k != "region.step")
        assert parts == round(side["region.step"] * 1e9) > 0
        assert "region.none" in side and all(v >= 0 for v in side.values())


def test_ssd_scan_nests_inside_the_ssd_mixer():
    """The hybrid's ``ssm_scan`` (`ssm._ssd`) opens and closes inside
    ``ssm`` in each phase (forward, the layer's recompute, backward): each
    run of scan intervals is entered from and left to ``ssm`` of its own
    phase, so the two never share an interval and ``ssm``'s own time is
    what the scan leaves; the scan runs once a layer in each phase."""
    cfg = _cfg("hymba-1.5b", **CASES["hybrid"][1])
    _, _, monitor = _train(cfg, True, steps=1)
    intervals = [(i["region"], i["phase"]) for i in monitor.regions.log[-1]["intervals"]]
    runs = {}
    for at, (name, phase) in enumerate(intervals):
        if name != "ssm_scan" or intervals[at - 1] == (name, phase):
            continue
        end = at
        while end + 1 < len(intervals) and intervals[end + 1] == (name, phase):
            end += 1
        assert intervals[at - 1] == ("ssm", phase), intervals[at - 2:end + 2]
        assert intervals[end + 1] == ("ssm", phase), intervals[at - 1:end + 3]
        runs[phase] = runs.get(phase, 0) + 1
    assert runs == dict.fromkeys(("fwd", "recompute", "bwd"), cfg.n_layers)
    side = _regions(monitor.recorder.last().side)
    for phase in ("fwd", "recompute", "bwd"):
        assert side[f"region.ssm.{phase}"] > 0 and side[f"region.ssm_scan.{phase}"] > 0


@pytest.mark.parametrize("remat,attn_remat", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_recompute_appears_only_under_remat(remat, attn_remat):
    _, _, monitor = _train(_cfg("granite-3-2b", remat=remat, attn_remat=attn_remat), True,
                           steps=1)
    side = _regions(monitor.recorder.last().side)
    recomputed = {k.split(".")[1] for k in side if k.endswith(".recompute")}
    if remat:  # the layer's re-run: every region of the layer
        assert recomputed == {"attention", "mlp"}
    elif attn_remat:  # the query blocks' re-run inside the attention's backward
        assert recomputed == {"attention"}
    else:
        assert recomputed == set()
    assert {"region.attention.fwd", "region.attention.bwd", "region.mlp.fwd",
            "region.mlp.bwd", "region.optimizer"} <= set(side)
    # a recompute that stops early closes what it opened: no region is
    # left open between the backward's end and the optimizer
    intervals = monitor.regions.log[-1]["intervals"]
    at = [i["region"] for i in intervals].index("optimizer")
    assert intervals[at - 1]["region"] == "none", intervals[at - 3:at]


def test_accumulated_microbatches_without_remat_read_no_recompute():
    """The second microbatch's forward runs after the first one's
    backward, never inside it: it is a forward."""
    _, _, monitor = _train(_cfg("granite-3-2b", remat=False, attn_remat=False), True,
                           steps=1, accum=2)
    side = _regions(monitor.recorder.last().side)
    assert not [k for k in side if k.endswith(".recompute")]
    assert side["region.attention.fwd"] > 0 and side["region.attention.bwd"] > 0


def test_a_profiler_turns_the_regions_on_and_off():
    cfg = _cfg("granite-3-2b")
    model = build_model(cfg)
    step, _ = build_train_step(model, make_local_mesh(device="cpu"), BASELINE_PLAN,
                               AdamWConfig(**OPT))
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    monitor = Monitor(fused_schema(world_size=1), window_steps=100)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    sides = []
    for i in range(3):
        if i == 1:
            prof.start()
        with monitor.step():
            state, _ = step(state, _batch(cfg, i))
        if i == 1:
            prof.stop()
        monitor.end_of_step()
        sides.append(_regions(monitor.recorder.last().side))
    assert not sides[0] and not sides[2]
    assert {k.split(".")[1] for k in sides[1]} >= REGION_NAMES


def test_boundaries_sit_on_the_profilers_clock():
    """Under a CPU profiler and the harness's loop with its stage spans,
    each step's boundaries (host times, `time.time_ns`) fall inside that
    step's ``stage:step.dispatch_cpu_wall`` event: the profiler's events
    and the regions share one clock."""
    from stagebench.loop import TrainLoop

    cfg = _cfg("granite-3-2b", remat=True)
    model = build_model(cfg)
    step, _ = build_train_step(model, make_local_mesh(device="cpu"), BASELINE_PLAN,
                               AdamWConfig(**OPT))
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    monitor = Monitor(fused_schema(world_size=1), window_steps=100)
    monitor.regions.log = []
    pipeline = PrefetchPipeline(SyntheticTokens(cfg.vocab_size, 2, 32, seed=1))
    loop = TrainLoop(step, state, monitor, pipeline, "cpu", spans=True)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    try:
        prof.start()
        for _ in range(3):
            loop.step()
        prof.stop()
    finally:
        pipeline.close()
    monitor.regions.settle()
    dispatch = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in prof.profiler.kineto_results.events()
                      if e.name() == "stage:step.dispatch_cpu_wall")
    assert len(dispatch) == len(monitor.regions.log) == 3
    for (start, end), logged in zip(dispatch, monitor.regions.log):
        times = [i["host_start_ns"] for i in logged["intervals"]] + [logged["host_end_ns"]]
        assert start <= min(times) and max(times) <= end, (start, end, times)


# -- the event path, on stand-in events ----------------------------------------------


class _Event:
    """A stand-in CUDA event: complete once the test says so; its time is
    the host ns it was recorded at."""

    made = 0
    done = True

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self):
        self.at = time.time_ns()

    def query(self):
        return type(self).done

    def synchronize(self):
        type(self).done = True

    def elapsed_time(self, later):
        assert type(self).done
        return (later.at - self.at) * 1e-6


class _OnCard:
    is_cuda = True


def test_event_fold_never_waits_and_reuses_events(monkeypatch):
    """A closed step whose last event has not completed is left by
    `poll`; its side settles when first read; each event goes back to the
    pool once read and is reused by the next step."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(_Event, "made", 0)
    recorder = StageRecorder(fused_schema(world_size=1))
    timer = regions.RegionTimer(recorder)

    def one_step():
        with timed_regions():
            assert timer.begin_step()
        with recorder.step():
            timer.forward_boundary("attention", True, "fwd", _OnCard())
            timer.forward_boundary("attention", False, "fwd", _OnCard())
            with timer.span("optimizer"):
                pass
        timer.end_step(recorder.last())
        return recorder.last()

    monkeypatch.setattr(_Event, "done", False)
    first = one_step()
    assert _Event.made == 4
    timer.poll()
    assert dict.get(first.side, "region.step") is None  # not folded: not complete
    side = _regions(first.side)  # the read settles it
    assert set(side) == {"region.attention.fwd", "region.none", "region.optimizer",
                         "region.step"}
    parts = sum(v for k, v in side.items() if k != "region.step")
    assert parts == pytest.approx(side["region.step"], rel=1e-12)
    monkeypatch.setattr(_Event, "done", True)
    second = one_step()
    timer.poll()
    assert "region.step" in dict.keys(second.side)  # folded by the poll
    assert _Event.made == 4  # the first step's events, reused


def test_add_side_value_adds_to_the_open_or_a_closed_step():
    recorder = StageRecorder(fused_schema(world_size=1))
    with recorder.step():
        recorder.add_side_value("x", 0.25)
        recorder.add_side_value("x", 0.5)
    record = recorder.last()
    recorder.add_side_value("x", 1.0, record)
    recorder.add_side_value("y", 2.0, record)
    assert record.side == {"x": 1.75, "y": 2.0}
    assert isinstance(record.side, SideValues)


# -- two Gloo ranks ------------------------------------------------------------------

_RANK = r"""
import contextlib, json, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.core.contract import fused_schema
from repro_torch.distributed.sharding import BASELINE_PLAN
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import build_train_step, init_train_state, shard_train_state
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.telemetry import Monitor, timed_regions
import dataclasses

rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)  # the ranks start at once and share the cores
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
cfg = dataclasses.replace(get_config("paper-gpt-125m").reduced(), remat=True,
                          attn_remat=True, attn_q_chunk=16, attn_kv_chunk=16)
model = build_model(cfg)
mesh = make_local_mesh(1, 2, device="cpu")
step, state_sh = build_train_step(model, mesh, BASELINE_PLAN,
                                  AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=10))
g = torch.Generator().manual_seed(5)
batches = [{k: torch.randint(0, cfg.vocab_size, (2, 32), generator=g, dtype=torch.int32)
            for k in ("tokens", "labels")} for _ in range(2)]

def run(on):
    state = shard_train_state(init_train_state(model, torch.Generator().manual_seed(0), "cpu"),
                              state_sh)
    monitor = Monitor(fused_schema(world_size=1), window_steps=100)
    monitor.regions.log = []
    losses = []
    with timed_regions() if on else contextlib.nullcontext():
        for b in batches:
            with monitor.step():
                state, m = step(state, b)
            monitor.end_of_step()
            losses.append(float(m["loss"]))
    params = {n: p.full_tensor() for n, p in state.params.named_parameters()}
    mu = {n: t.full_tensor() for n, t in state.opt.mu.items()}
    keys = sorted(k for k in monitor.recorder.last().side if k.startswith("region."))
    return losses, params, mu, keys

off, on = run(False), run(True)
same = (off[0] == on[0] and all(torch.equal(off[1][n], on[1][n]) for n in off[1])
        and all(torch.equal(off[2][n], on[2][n]) for n in off[2]))
with open(out + f".{rank}", "w") as f:
    json.dump({"same": same, "losses": on[0], "off_keys": off[3], "on_keys": on[3]}, f)
dist.destroy_process_group()
"""


def test_two_gloo_ranks_regions_change_no_number(tmp_path):
    """The sharded step under BASELINE_PLAN on (1, 2): the regions on
    against off, bit for bit on each rank."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = str(tmp_path / "rank")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               f"file://{tmp_path / 'gloo_init'}", out],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    try:
        for p in procs:
            _, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in range(2):
        with open(f"{out}.{r}") as f:
            got = json.load(f)
        assert got["same"], got
        assert got["off_keys"] == []
        assert {k.split(".")[1] for k in got["on_keys"]} >= REGION_NAMES
        assert "region.attention.recompute" in got["on_keys"]
