"""The PyTorch port's per-job monitor against the reference, on CPU.

Policy, device events, the failure-safe gather (in process, and live on
Gloo through `TorchDistTransport`) and the `Monitor` itself.  Both
packages take the same inputs, made with numpy from a seed.  Tolerance:
none — the monitor is NumPy code in both packages, so reports, packet
bytes and actions must be equal; only the wall-clock `elapsed_s` of a
gather differs.
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

from repro.core import WindowAggregator as RefAggregator  # noqa: E402
from repro.core.contract import fused_schema as ref_fused_schema  # noqa: E402
from repro.distributed import MonitorPolicy as RefPolicy  # noqa: E402
from repro.sim import simulate  # noqa: E402
from repro.sim.scenarios import ddp_scenario, hidden_rank_scenario  # noqa: E402
from repro.telemetry import DeviceEventChannel as RefChannel  # noqa: E402
from repro.telemetry import InProcTransport as RefInProc  # noqa: E402
from repro.telemetry import Monitor as RefMonitor  # noqa: E402
from repro.telemetry import StepRecord as RefStepRecord  # noqa: E402
from repro.telemetry import TelemetryGather as RefGather  # noqa: E402
from repro.telemetry import encode_packet as ref_encode  # noqa: E402
from repro_torch.core import WindowAggregator  # noqa: E402
from repro_torch.core.contract import fused_schema  # noqa: E402
from repro_torch.distributed import MonitorPolicy  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    DeviceEventChannel,
    InProcTransport,
    Monitor,
    StepRecord,
    TelemetryGather,
    TorchDistTransport,
    encode_packet,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# Policy (tests/test_runtime.py::TestPolicy, on both packages)
# ---------------------------------------------------------------------------


def _reports(durations, schema, agg_cls, gather_ok):
    agg = agg_cls(schema, window_steps=durations.shape[0])
    rep = None
    for t in range(durations.shape[0]):
        rep = agg.add_step(durations[t], durations[t].sum(-1), gather_ok=gather_ok) or rep
    return rep


def _policy_actions(windows, schema, policy_kw, gather_ok):
    """The actions each package's policy takes on the same windows."""
    out = []
    for agg_cls, policy_cls in ((RefAggregator, RefPolicy), (WindowAggregator, MonitorPolicy)):
        policy = policy_cls(**policy_kw)
        acts = []
        for d in windows:
            acts += policy.on_report(_reports(d, schema, agg_cls, gather_ok))
        out.append([dataclasses.asdict(a) for a in acts])
    return out


class TestPolicy:
    def test_reshard_after_persistent_gather_failure(self):
        sc = ddp_scenario(world_size=4, steps=30, seed=0)
        res = simulate(sc)
        windows = [res.durations[w * 10:(w + 1) * 10] for w in range(3)]
        want, got = _policy_actions(windows, sc.schema(), {"reshard_after": 2}, False)
        assert got == want
        assert any(a["kind"] == "checkpoint_reshard" for a in got)

    def test_no_action_on_healthy_windows(self):
        sc = ddp_scenario(world_size=4, steps=20, seed=1)
        res = simulate(sc)
        want, got = _policy_actions([res.durations], sc.schema(), {}, True)
        assert got == want
        assert not any(a["kind"] in ("rebalance_data", "quarantine_rank") for a in got)

    def test_data_straggler_rebalance(self):
        sc = hidden_rank_scenario("data", world_size=8, steps=30, seed=3, delay_ms=150.0)
        res = simulate(sc)
        want, got = _policy_actions([res.durations] * 2, sc.schema(),
                                    {"leader_persistence": 2}, True)
        assert got == want
        rb = [a for a in got if a["kind"] == "rebalance_data"]
        assert rb and rb[0]["rank"] == sc.faults[0].rank


# ---------------------------------------------------------------------------
# Device events (tests/test_telemetry.py::TestDeviceEvents)
# ---------------------------------------------------------------------------


class _Event:
    """A stub `torch.cuda.Event`: `query()` says whether it completed."""

    def __init__(self, ready):
        self.ready = ready

    def query(self):
        return self.ready


class _RefHandle:
    def __init__(self, ready):
        self.ready = ready

    def is_ready(self):
        return self.ready


def _channel_state(ch):
    return dict(steps=[s for s, _, _ in ch.samples], cpu=[c for _, _, c in ch.samples],
                pending=[p.step for p in ch._pending], attempts=ch.attempts,
                dropped=ch.dropped, ratio=ch.ready_ratio)


class TestDeviceEvents:
    def test_sampling_period(self):
        for q in (0.0, 0.05, 0.3, 1.0):
            ref, port = RefChannel(q), DeviceEventChannel(q)
            assert [s for s in range(200) if port.should_sample(s)] == [
                s for s in range(200) if ref.should_sample(s)]
        assert [s for s in range(100) if DeviceEventChannel(0.05).should_sample(s)] == [
            0, 20, 40, 60, 80]
        with pytest.raises(ValueError):
            DeviceEventChannel(1.5)

    def test_poll_with_query_handles(self):
        """Handles ready and not yet ready, polled twice: the same samples,
        pending steps and ratio as the reference's `is_ready` handles."""
        ready = np.random.default_rng(4).random(12) < 0.5
        ref, port = RefChannel(1.0), DeviceEventChannel(1.0)
        ref_h = [_RefHandle(bool(r)) for r in ready]
        port_h = [_Event(bool(r)) for r in ready]
        for i in range(6):
            ref.observe(i, ref_h[i], cpu_wall_ms=float(i))
            port.observe(i, port_h[i], cpu_wall_ms=float(i))
        assert [s for s, _, _ in port.poll()] == [s for s, _, _ in ref.poll()]
        for h, g in zip(ref_h, port_h):  # everything completes
            h.ready = g.ready = True
        assert [s for s, _, _ in port.poll()] == [s for s, _, _ in ref.poll()]
        assert _channel_state(port) == _channel_state(ref)
        assert port.ready_ratio == 1.0
        assert all(ms >= 0 for _, ms, _ in port.samples)

    def test_cpu_tensor_reads_ready(self):
        ch = DeviceEventChannel(1.0)
        ch.observe(0, torch.ones(()), 5.0)
        assert [s for s, _, _ in ch.poll()] == [0] and ch.ready_ratio == 1.0

    def test_bounded_pending(self):
        ref, port = RefChannel(1.0, max_pending=2), DeviceEventChannel(1.0, max_pending=2)
        for i in range(5):
            ref.observe(i, _RefHandle(False), 1.0)
            port.observe(i, _Event(False), 1.0)
        assert len(port._pending) == 2 and port.dropped == 3
        assert _channel_state(port) == _channel_state(ref)


# ---------------------------------------------------------------------------
# Gather (tests/test_telemetry.py::TestGather), field by field
# ---------------------------------------------------------------------------


def _fields(res):
    return dict(ok=res.ok, present=res.present_ranks, error=res.error,
                window=None if res.window is None else res.window.tolist(),
                parts=[None if p is None else p.tolist() for p in res.parts])


def _both(make_transport, deposit, local, **gather_kw):
    out = []
    for transport_cls, gather_cls in ((RefInProc, RefGather), (InProcTransport, TelemetryGather)):
        tr = make_transport(transport_cls)
        for r, part in deposit:
            tr.deposit(r, part)
        out.append(_fields(gather_cls(tr, 0, **gather_kw).gather_window(local)))
    return out


class TestGather:
    rng = np.random.default_rng(11)

    def test_success(self):
        parts = [self.rng.standard_normal((10, 6)) for _ in range(4)]
        want, got = _both(lambda c: c(4), list(enumerate(parts)), parts[0])
        assert got == want
        assert got["ok"] and np.array_equal(np.array(got["window"]), np.stack(parts, axis=1))

    def test_failed_rank_downgrades(self):
        parts = [self.rng.standard_normal((5, 6)) for _ in range(4)]
        want, got = _both(lambda c: c(4, fail_ranks=frozenset({2})), list(enumerate(parts)),
                          parts[0])
        assert got == want
        assert not got["ok"] and 2 not in got["present"] and got["window"] is None

    def test_timeout_downgrades(self):
        local = self.rng.standard_normal((2, 6))
        want, got = _both(lambda c: c(2, slow_ranks=frozenset({1}), slow_delay_s=10.0),
                          [], local, timeout_s=0.1)
        assert got == want
        assert not got["ok"] and got["present"] == (0,)

    def test_transport_exception_never_raises(self):
        class Broken:
            def allgather(self, *a, **k):
                raise RuntimeError("link down")

        want = _fields(RefGather(Broken(), 0).gather_window(np.ones((2, 6))))
        got = _fields(TelemetryGather(Broken(), 0).gather_window(np.ones((2, 6))))
        assert got == want
        assert not got["ok"] and "transport" in got["error"]

    def test_dist_transport_needs_a_group(self):
        with pytest.raises(RuntimeError, match="init_process_group"):
            TorchDistTransport()


# ---------------------------------------------------------------------------
# TorchDistTransport, live on Gloo: three ranks, one process each
# ---------------------------------------------------------------------------

_WORLD = 3
_TIMEOUT_S = 2.0
_GLOO_RANK = r"""
import json, os, sys, time
import numpy as np
import torch.distributed as dist
from repro_torch.telemetry import TelemetryGather, TorchDistTransport

rank, world, init, absent, timeout_s = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
    float(sys.argv[5]))
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
out = {"rank": rank}
if rank == absent:
    time.sleep(timeout_s + 2)  # joined the group, never calls the gather
else:
    tr = TorchDistTransport()
    local = np.random.default_rng(rank).standard_normal((7, 6))
    t0 = time.perf_counter()
    res = TelemetryGather(tr, tr.rank, timeout_s=timeout_s).gather_window(local)
    out.update(ok=res.ok, present=list(res.present_ranks), error=res.error,
               seconds=time.perf_counter() - t0, world=tr.world_size,
               window=None if res.window is None else res.window.tolist(),
               own=None if res.parts == () else res.parts[rank].tolist())
print(json.dumps(out), flush=True)
if absent < 0:
    dist.destroy_process_group()
os._exit(0)  # a timed-out collective may still wait in Gloo's threads
"""


def _gloo_ranks(tmp_path, absent):
    """Run the three ranks; each is joined with its own deadline."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    init = f"file://{tmp_path / 'gloo_init'}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _GLOO_RANK, str(r), str(_WORLD), init, str(absent),
             str(_TIMEOUT_S)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(_WORLD)
    ]
    out = []
    deadline = time.monotonic() + 60
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, stderr[-2000:]
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.poll() is not None for p in procs)
    return out


class TestTorchDistTransportGloo:
    def test_three_ranks_gather_the_stacked_window(self, tmp_path):
        results = _gloo_ranks(tmp_path, absent=-1)
        parts = [np.random.default_rng(r).standard_normal((7, 6)) for r in range(_WORLD)]
        want = np.stack(parts, axis=1)  # [N, R, S]
        for res in results:
            assert res["ok"], res["error"]
            assert res["world"] == _WORLD and res["present"] == [0, 1, 2]
            np.testing.assert_array_equal(np.array(res["window"]), want)

    def test_rank_that_never_calls_fails_the_gather_safely(self, tmp_path):
        results = _gloo_ranks(tmp_path, absent=_WORLD - 1)
        for res in results[:-1]:
            r = res["rank"]
            assert not res["ok"] and res["window"] is None
            assert res["present"] == [r]
            assert res["seconds"] < _TIMEOUT_S + 10
            np.testing.assert_array_equal(
                np.array(res["own"]), np.random.default_rng(r).standard_normal((7, 6)))
        assert "ok" not in results[-1]


# ---------------------------------------------------------------------------
# Monitor
# ---------------------------------------------------------------------------


def _monitors(schema, rows, *, transport=None, rank=0, window=10):
    out = []
    for monitor_cls, record_cls, transport_cls in (
        (RefMonitor, RefStepRecord, RefInProc), (Monitor, StepRecord, InProcTransport)
    ):
        tr = transport(transport_cls) if transport else None
        mon = monitor_cls(schema, rank=rank, transport=tr, window_steps=window,
                          keep_windows=True)
        reports = []
        for t, row in enumerate(rows):
            rec = record_cls(step=t, durations=dict(zip(schema.stages, row.tolist())),
                             wall=float(row.sum()))
            mon.recorder.last = lambda rec=rec: rec
            if tr is not None and (t + 1) % window == 0:
                block = rows[t + 1 - window:t + 1]
                for r in range(schema.world_size):
                    if r != rank:  # the other ranks' windows, scaled apart
                        tr.deposit(r, block * (1.0 + 0.1 * r))
            rep = mon.end_of_step()
            if rep is not None:
                reports.append(rep)
        out.append((mon, reports))
    return out


def _report_fields(rep):
    d = rep.diagnosis
    return dict(index=rep.window_index, steps=rep.steps, labels=d.labels,
                routing=d.routing_stages, shares=d.shares, gains=d.gains,
                gather_ok=d.gather_ok, durations=rep.durations.tolist())


def _stage_rows(seed, steps, schema):
    rng = np.random.default_rng(seed)
    rows = rng.gamma(4.0, 0.01, size=(steps, schema.num_stages))
    rows[::7, 0] += 0.2  # a recurring data stall
    return rows


class TestMonitor:
    def test_single_process(self):
        schema_ref, schema = ref_fused_schema(world_size=1), fused_schema(world_size=1)
        rows = _stage_rows(0, 35, schema)
        (ref, ref_reps), _ = _monitors(schema_ref, rows)
        _, (port, port_reps) = _monitors(schema, rows)
        assert len(port_reps) == len(ref_reps) == 3
        assert [_report_fields(r) for r in port_reps] == [_report_fields(r) for r in ref_reps]
        assert [encode_packet(p) for p in port.packets] == [ref_encode(p) for p in ref.packets]
        assert [dataclasses.asdict(a) for a in port.actions] == [
            dataclasses.asdict(a) for a in ref.actions]
        assert port.monitor_path_seconds > 0

    def test_four_ranks_with_a_failed_rank(self):
        """Rank 2 never contributes: every window is telemetry_limited, and
        the third in a row proposes checkpoint_reshard."""
        schema_ref, schema = ref_fused_schema(world_size=4), fused_schema(world_size=4)
        rows = _stage_rows(1, 40, schema)

        def failing(cls):
            return cls(4, fail_ranks=frozenset({2}))

        (ref, ref_reps), _ = _monitors(schema_ref, rows, transport=failing)
        _, (port, port_reps) = _monitors(schema, rows, transport=failing)
        assert len(port_reps) == len(ref_reps) == 4
        assert [_report_fields(r) for r in port_reps] == [_report_fields(r) for r in ref_reps]
        assert [encode_packet(p) for p in port.packets] == [ref_encode(p) for p in ref.packets]
        assert all("telemetry_limited" in r.diagnosis.labels for r in port_reps)
        assert [p.present_ranks for p in port.packets] == [(0, 1, 3)] * 4
        kinds = [(a.window_index, a.kind) for a in port.actions]
        assert kinds == [(a.window_index, a.kind) for a in ref.actions]
        assert kinds == [(2, "checkpoint_reshard")]

    def test_on_action_failure_never_reaches_training(self):
        schema = fused_schema(world_size=4)
        seen = []

        def boom(action):
            seen.append(action.kind)
            raise RuntimeError("operator hook down")

        mon = Monitor(schema, transport=InProcTransport(4, fail_ranks=frozenset({1})),
                      window_steps=5, on_action=boom)
        for t, row in enumerate(_stage_rows(2, 15, schema)):
            rec = StepRecord(step=t, durations=dict(zip(schema.stages, row.tolist())),
                             wall=float(row.sum()))
            mon.recorder.last = lambda rec=rec: rec
            mon.end_of_step()
        assert seen == ["checkpoint_reshard"]
        assert [a.kind for a in mon.actions] == ["checkpoint_reshard"]
