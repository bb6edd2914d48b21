"""The PyTorch port's incident tier against the JAX reference, on CPU.

The co-activation statistics are integer counts, so the port's plain
torch route must equal the reference's Pallas route (interpret mode off
the TPU) and the NumPy oracles exactly.  The incident engine and the
`serve_fleet --topology private|shared|fabric` driver must produce the
same incidents, promotions, tiers and escalations as the reference; only
`exposure_s` and `score`, sums of the routed recoverable seconds, are
held to rtol 1e-4, as `tests/test_torch_fleet.py` holds `recoverable_s`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fleet import FleetService as RefService  # noqa: E402
from repro.incidents import IncidentEngine as RefEngine  # noqa: E402
from repro.incidents import Topology as RefTopology  # noqa: E402
from repro.kernels import frontier as jfr  # noqa: E402
from repro.launch import serve_fleet as ref_serve  # noqa: E402
from repro_torch.core import WindowAggregator  # noqa: E402
from repro_torch.fleet import FleetService  # noqa: E402
from repro_torch.incidents import IncidentEngine, Topology  # noqa: E402
from repro_torch.kernels.frontier import incidents as tin  # noqa: E402
from repro_torch.launch import serve_fleet as port_serve  # noqa: E402
from repro_torch.sim import simulate  # noqa: E402
from repro_torch.sim.scenarios import shared_host_fleet  # noqa: E402
from repro_torch.telemetry.packets import encode_packet, from_diagnosis  # noqa: E402

RTOL = 1e-4
_FIELDS = ("jobs", "coact", "active")

# J = 1, H = 1, H past one 128-lane tile, S not a multiple of 8 (5, 9)
#: (J, N, H, S); the last three are the CUDA kernel's edges at narrow
#: widths: job counts no multiple of its job split (67, 130), one step,
#: and 33 columns, no multiple of its column tile
_SHAPES = [(1, 1, 1, 1), (1, 5, 4, 6), (2, 5, 4, 6), (3, 7, 130, 6),
           (4, 8, 9, 9), (3, 6, 1, 5), (5, 12, 17, 5),
           (67, 3, 5, 6), (130, 2, 3, 2), (4, 1, 33, 1)]


def _act(shape, seed, p=0.3):
    return np.random.default_rng(seed).random(shape) < p


def _tiers(h, rng, kind=jfr.TierAxes):
    """A switch and a pod tier over h hosts, with -1 (no node) entries."""
    n_sw, n_pod = max(1, h // 3), max(1, h // 7)
    return (
        kind("switch", n_sw, tuple(int(g) for g in rng.integers(-1, n_sw, h))),
        kind("pod", n_pod, tuple(int(g) for g in rng.integers(-1, n_pod, h))),
    )


def _assert_packets_equal(got, want, msg=""):
    for field in _FIELDS:
        g = getattr(got, field)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(getattr(want, field))
        assert g.dtype == np.int32, f"{msg} {field} dtype {g.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} {field}")


class TestCoActivation:
    @pytest.mark.parametrize("shape", _SHAPES)
    @pytest.mark.parametrize("seed", [0, 1])
    def test_plain_equals_reference_kernel_and_oracle(self, shape, seed):
        act = _act(shape, seed)
        got = tin.co_activation(act, device="cpu")
        _assert_packets_equal(got, jfr.co_activation(act), f"{shape} jax")
        _assert_packets_equal(got, jfr.co_activation_ref(act), f"{shape} jax ref")
        _assert_packets_equal(got, tin.co_activation_ref(act), f"{shape} ref")

    @pytest.mark.parametrize("shape", _SHAPES[:4])
    def test_loop_equals_batched(self, shape):
        act = _act(shape, 3)
        got = tin.co_activation_loop(act, device="cpu")
        _assert_packets_equal(got, jfr.co_activation_loop(act), f"{shape} loop")

    def test_integer_and_tensor_inputs(self):
        act = _act((3, 4, 5, 2), 4)
        want = tin.co_activation_ref(act)
        for a in (act.astype(np.int32), torch.from_numpy(act),
                  torch.from_numpy(act.astype(np.uint8))):
            _assert_packets_equal(tin.co_activation(a, device="cpu"), want)

    def test_ref_semantics(self):
        act = np.zeros((3, 4, 2, 2), bool)
        act[0, :2, 0, 0] = True      # job 0 active steps 0-1
        act[1, 1:3, 0, 0] = True     # job 1 active steps 1-2 (overlap at 1)
        act[2, 3, 1, 1] = True       # job 2 alone elsewhere
        got = tin.co_activation(act, device="cpu")
        assert got.jobs[0, 0] == 2 and got.jobs[1, 1] == 1
        assert got.coact[0, 0] == 1
        assert got.active[0, 0] == 4

    def test_many_jobs_equal_the_oracle(self):
        """32,768 jobs in one call, past the ~14,500 whose job arrays the
        CUDA kernel once needed in shared memory at once: the plain
        version equals the reference's NumPy oracle exactly."""
        act = _act((32768, 3, 2, 2), 16, p=0.05)
        got = tin.co_activation(act, device="cpu")
        _assert_packets_equal(got, jfr.co_activation_ref(act), "32768 jobs")
        assert int(got.jobs.max()) > 1000

    def test_rejects_bad_rank(self):
        with pytest.raises(ValueError):
            tin.co_activation(np.zeros((2, 3, 4)), device="cpu")
        with pytest.raises(ValueError):
            tin.co_activation_ref(np.zeros((2, 3, 4)))


class TestTieredCoActivation:
    @pytest.mark.parametrize("shape", _SHAPES)
    def test_one_launch_matches_reference_per_tier(self, shape):
        act = _act(shape, 0)
        for with_tiers in (False, True):
            jt = _tiers(shape[2], np.random.default_rng(7)) if with_tiers else ()
            pt = tuple(tin.TierAxes(*t) for t in jt)
            got = tin.tiered_co_activation(act, pt, device="cpu")
            jax_route = jfr.tiered_co_activation(act, jt)
            oracle = tin.tiered_co_activation_ref(act, pt)
            assert len(got) == len(jax_route) == len(oracle) == 1 + len(jt)
            for t, (g, w, o) in enumerate(zip(got, jax_route, oracle)):
                _assert_packets_equal(g, w, f"{shape} tier#{t} jax")
                _assert_packets_equal(g, o, f"{shape} tier#{t} ref")
                _assert_packets_equal(
                    o, jfr.tiered_co_activation_ref(act, jt)[t], "oracle copy"
                )

    def test_every_host_unmapped(self):
        act = _act((2, 5, 4, 3), 2)
        tiers = (tin.TierAxes("switch", 2, (-1, -1, -1, -1)),)
        _, sw = tin.tiered_co_activation(act, tiers, device="cpu")
        assert not sw.jobs.any() and not sw.active.any()

    def test_no_tiers_is_plain_co_activation(self):
        act = _act((2, 6, 5, 3), 1, p=0.4)
        (only,) = tin.tiered_co_activation(act, (), device="cpu")
        _assert_packets_equal(only, tin.co_activation(act, device="cpu"))

    def test_rejects_misaligned_grouping(self):
        act = np.zeros((1, 2, 4, 2), bool)
        bad = (tin.TierAxes("switch", 2, (0, 1)),)
        with pytest.raises(ValueError, match="grouping covers"):
            tin.tiered_co_activation(act, bad, device="cpu")
        with pytest.raises(ValueError, match="grouping covers"):
            tin.tiered_co_activation_ref(act, bad)


class TestKernelBoundary:
    def test_cpu_route_never_launches(self, monkeypatch):
        monkeypatch.setattr(tin, "launches", 0)
        tin.tiered_co_activation(_act((2, 3, 4, 2), 0), (), device="cpu")
        tin.co_activation_loop(_act((2, 3, 4, 2), 0), device="cpu")
        assert tin.launches == 0

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        a = torch.zeros((1, 2, 3, 4), dtype=torch.uint8)
        with pytest.raises(ValueError, match="CUDA tensors"):
            tin._co_activation_cuda(a)

    def test_arrays_default_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tin.co_activation(_act((1, 2, 3, 4), 0))


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class E:
    """Route-entry-shaped test record (duck-types fleet RouteEntry)."""

    job_id: str
    stage: str
    rank: int
    recoverable_s: float
    persistence: float = 1.0
    regime: str = "persistent"
    onset_step: int = 0
    window_index: int = 0


STAGES = ("s0", "s1")
FAB_RANK = {"a": 2, "b": 1, "c": 0}


def _shared_activity(rank, *, n=6, r=4, s=2):
    a = np.zeros((n, r, s), bool)
    a[:, rank, 0] = True
    return a


def _two_jobs(topology_cls):
    return topology_cls.from_jobs(
        {"a": ("h0", "h0", "shared", "h1"), "b": ("g0", "shared", "g1", "g1")}
    )


def _shared_host_under_switch(topology_cls):
    hosts = {"a": ("h0", "h0", "shared", "h1"),
             "b": ("g0", "shared", "g1", "g1")}
    return topology_cls.from_jobs(
        hosts,
        switches={j: ("sw-up",) * 4 for j in hosts},
        pods={j: ("p-up",) * 4 for j in hosts},
    )


def _uplink(topology_cls, shared_tier):
    """Three jobs, each faulted rank on its own host; the faulted hosts
    share a switch ("switch") or only a pod ("pod")."""
    hosts = {"a": ("a0", "a0", "ha", "a1"), "b": ("b0", "hb", "b1", "b1"),
             "c": ("hc", "c0", "c0", "c1")}
    faulted = {"a": "ha", "b": "hb", "c": "hc"}
    switches, pods = {}, {}
    for j, hs in hosts.items():
        sw = [f"{h}.sw" for h in hs]
        pd = [f"{h}.pod" for h in hs]
        for r, h in enumerate(hs):
            if h == faulted[j] and shared_tier in ("switch", "pod"):
                if shared_tier == "switch":
                    sw[r] = "sw-up"
                pd[r] = "p-up"
        switches[j], pods[j] = tuple(sw), tuple(pd)
    return topology_cls.from_jobs(hosts, switches=switches, pods=pods)


def _two_job_case(topo):
    entries = [E("a", "s0", 2, 1.5, window_index=1),
               E("b", "s0", 1, 2.5, window_index=1)]
    act = {"a": (_shared_activity(2), STAGES), "b": (_shared_activity(1), STAGES)}
    return topo, entries, act


def _fabric_case(topo):
    entries = [E(j, "s0", FAB_RANK[j], 1.0, window_index=1) for j in sorted(FAB_RANK)]
    act = {j: (_shared_activity(r), STAGES) for j, r in FAB_RANK.items()}
    return topo, entries, act


#: name -> (topology builder, case builder, expected fleet (tier, node))
_SCENARIOS = {
    "two_job_merge": (_two_jobs, _two_job_case, [("host", "shared")]),
    "three_hosts_one_switch": (
        lambda t: _uplink(t, "switch"), _fabric_case, [("switch", "sw-up")]),
    "host_claims_before_switch": (
        _shared_host_under_switch, _two_job_case, [("host", "shared")]),
    "pod_last_resort": (lambda t: _uplink(t, "pod"), _fabric_case, [("pod", "p-up")]),
    "private_fabric": (lambda t: _uplink(t, "none"), _fabric_case, []),
}


def _observe(engine, case, ticks=3):
    _, entries, act = case
    tables = []
    for tick in range(1, ticks + 1):
        engine.observe(tick, entries if tick < 3 else entries[:1], activity=act)
        tables.append(engine.table(live_only=False))
    return tables


class TestEngineParity:
    @pytest.mark.parametrize("use_kernel", [False, True])
    @pytest.mark.parametrize("name", sorted(_SCENARIOS))
    def test_same_incidents_as_reference(self, name, use_kernel):
        topo_of, case_of, fleet_want = _SCENARIOS[name]
        port = IncidentEngine(topology=topo_of(Topology), device="cpu")
        ref = RefEngine(topology=topo_of(RefTopology), use_kernel=use_kernel)
        got = _observe(port, case_of(None))
        want = _observe(ref, case_of(None))
        assert got == want
        fleet = [(i.tier, i.host) for i in port.incidents() if i.scope == "fleet"]
        assert fleet == fleet_want
        assert port.counts() == ref.counts()

    def test_through_the_service(self):
        """Simulator -> aggregator -> SFP2-v2 wire (hosts) -> service ->
        engine, the port beside the reference on the same packets."""
        fl = shared_host_fleet(jobs=4, shared_jobs=2, steps=40, seed=1)
        port = FleetService(window_capacity=20, device="cpu",
                            incidents=IncidentEngine(device="cpu"))
        ref = RefService(window_capacity=20, incidents=RefEngine())
        sims = {j: simulate(sc) for j, sc in fl.scenarios.items()}
        aggs = {j: WindowAggregator(sc.schema(), window_steps=20)
                for j, sc in fl.scenarios.items()}
        for w in range(2):
            batch = []
            for jid, sc in fl.scenarios.items():
                block = sims[jid].durations[w * 20:(w + 1) * 20]
                report = None
                for t in range(20):
                    report = aggs[jid].add_step(block[t], block[t].sum(-1)) or report
                pkt = from_diagnosis(
                    report.diagnosis, sc.stages, report.steps, sc.world_size,
                    report.window_index, window=report.durations,
                    sync_stages=sc.sync_stages, first_step=w * 20, hosts=sc.hosts,
                )
                batch.append((jid, encode_packet(pkt, compress="int8")))
            for svc in (port, ref):
                svc.submit_many(batch, refresh=True)
                svc.tick()
        fleet = [i for i in port.incidents.incidents() if i.scope == "fleet"]
        assert len(fleet) == 1 and fleet[0].host == fl.shared_host
        assert fleet[0].member_jobs == fl.shared_job_ids
        _assert_tables_agree(port.incidents.table(), ref.incidents.table())
        snap, want = port.snapshot(), ref.snapshot()
        snap.pop("obs"), want.pop("obs")
        assert snap == want
        assert snap["incidents"]["merged"] == 2


# ---------------------------------------------------------------------------
# serve_fleet --topology against the reference driver
# ---------------------------------------------------------------------------

ARGV = ["--jobs", "6", "--ranks", "8", "--window", "20", "--rounds", "3"]
_EXACT = ("id", "scope", "job", "stage", "ranks", "host", "tier", "state",
          "onset_step", "opened_tick", "windows", "escalations",
          "resolve_reason", "member_jobs", "regime", "persistence")


def _assert_tables_agree(got, want):
    assert [r["id"] for r in got] == [r["id"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in _EXACT:
            assert g[k] == w[k], (g["id"], k)
        assert g["exposure_s"] == pytest.approx(w["exposure_s"], rel=RTOL)


@pytest.fixture(scope="module", params=["private", "shared", "fabric"])
def topology_runs(request):
    argv = ARGV + ["--topology", request.param]
    ref = ref_serve.run(ref_serve.make_argparser().parse_args(argv))
    port = port_serve.run(
        port_serve.make_argparser().parse_args(argv + ["--device", "cpu"])
    )
    return request.param, ref, port


class TestServeFleetTopologies:
    def test_incident_tables_agree(self, topology_runs):
        _, ref, port = topology_runs
        assert ref["incidents"], "the reference opened no incident"
        _assert_tables_agree(port["incidents"], ref["incidents"])

    def test_escalations_agree_in_order(self, topology_runs):
        _, ref, port = topology_runs
        got, want = port["escalations"], ref["escalations"]
        assert want, "the reference escalated nothing"
        assert [{k: v for k, v in a.items() if k != "score"} for a in got] == [
            {k: v for k, v in a.items() if k != "score"} for a in want
        ]
        for g, w in zip(got, want):
            assert g["score"] == pytest.approx(w["score"], rel=RTOL)

    def test_snapshots_and_routes_agree(self, topology_runs):
        _, ref, port = topology_runs
        assert port["snapshot"] == ref["snapshot"]
        assert "incidents" in port["snapshot"] and "rehomed" in port["snapshot"]
        key = ("job", "stage", "rank", "regime")
        assert [tuple(r[k] for k in key) for r in port["routing"]] == [
            tuple(r[k] for k in key) for r in ref["routing"]
        ]
        assert sorted(port) == sorted(ref)

    def test_common_cause_tier(self, topology_runs):
        topology, _, port = topology_runs
        fleet = [(r["tier"], r["host"]) for r in port["incidents"]
                 if r["scope"] == "fleet"]
        want = {"private": [], "shared": [("host", "shared-0")],
                "fabric": [("switch", "fab-sw0")]}[topology]
        assert fleet == want

    def test_correlate_phase_is_timed(self, topology_runs):
        _, _, port = topology_runs
        hist = port["obs"]["metrics"]["histograms"]
        assert "phase_seconds.tick.correlate" in hist
