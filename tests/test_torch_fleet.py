"""The PyTorch port's fleet service against the reference, on CPU.

`repro.launch.serve_fleet.run` and `repro_torch.launch.serve_fleet.run`
(`--device cpu`: the tick kernels' plain torch versions) serve the same
simulated fleet, through the fused tick and through the four-dispatch
reference route (`FleetService(fused=False)`).  Their routes must name the same (job, stage, rank,
regime) with `recoverable_s` within rtol 1e-4, and their snapshots must
agree apart from the wall-clock `obs` section.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve_fleet as ref_serve  # noqa: E402
from repro_torch.fleet import FleetService  # noqa: E402
from repro_torch.incidents import IncidentEngine  # noqa: E402
from repro_torch.kernels.frontier import fused  # noqa: E402
from repro_torch.launch import serve_fleet as port_serve  # noqa: E402
from repro_torch.telemetry.packets import EvidencePacket  # noqa: E402

ARGV = ["--jobs", "6", "--ranks", "8", "--window", "20", "--rounds", "3"]
RTOL = 1e-4


def _runs(extra=()):
    argv = ARGV + list(extra)
    ref = ref_serve.run(ref_serve.make_argparser().parse_args(argv))
    port = port_serve.run(
        port_serve.make_argparser().parse_args(argv + ["--device", "cpu"])
    )
    return ref, port


@pytest.fixture(scope="module")
def default_runs():
    return _runs()


def _assert_routes_agree(ref, port):
    want, got = ref["routing"], port["routing"]
    assert want, "the reference routed nothing"
    key = ("job", "stage", "rank", "regime")
    assert [tuple(r[k] for k in key) for r in got] == [
        tuple(r[k] for k in key) for r in want
    ]
    for g, w in zip(got, want):
        assert g["recoverable_s"] == pytest.approx(w["recoverable_s"], rel=RTOL)
    # the order is only meaningful if no two scores are within the
    # tolerance of each other: a near-tie could swap under rounding
    scores = [r["score"] for r in want]
    for hi, lo in zip(scores, scores[1:]):
        assert hi - lo > 10 * RTOL * hi, f"near-tie in route scores {scores}"


class TestServeFleetParity:
    def test_routes_agree(self, default_runs):
        _assert_routes_agree(*default_runs)

    def test_snapshots_agree(self, default_runs):
        ref, port = default_runs
        assert port["snapshot"] == ref["snapshot"]

    def test_summary_shape_agrees(self, default_runs):
        ref, port = default_runs
        assert sorted(port) == sorted(ref)
        for k in ("jobs", "rounds", "shards", "wire", "compress",
                  "packets_sent", "wire_bytes", "wire_bytes_per_packet"):
            assert port[k] == ref[k], k
        assert port["obs"]["metrics"]["counters"]["jobs_refreshed"] == (
            ref["obs"]["metrics"]["counters"]["jobs_refreshed"]
        )

    @pytest.mark.parametrize("compress", ["none", "int8.delta"])
    def test_other_wire_payloads(self, compress):
        _assert_routes_agree(*_runs(["--compress", compress]))

    def test_cpu_run_never_launches(self):
        before = fused.launches
        port_serve.run(port_serve.make_argparser().parse_args(
            ["--jobs", "3", "--ranks", "4", "--window", "5", "--rounds", "2",
             "--device", "cpu"]
        ))
        assert fused.launches == before


class TestIncidentTier:
    def test_service_with_incident_engine_ticks(self):
        """An attached engine is fed every tick and reported."""
        engine = IncidentEngine(device="cpu")
        service = FleetService(device="cpu", incidents=engine)
        assert service.incidents is engine
        assert service.tick() == []
        snap = service.snapshot()
        assert snap["tick"] == 1
        assert snap["incidents"] == engine.counts()
        assert snap["rehomed"] == 0
        assert "incidents" not in FleetService(device="cpu").snapshot()

    def test_topology_flag_parses_and_runs(self):
        args = port_serve.make_argparser().parse_args(
            ["--jobs", "4", "--ranks", "4", "--window", "5", "--rounds", "2",
             "--topology", "fabric", "--budget", "1", "--device", "cpu"]
        )
        assert (args.topology, args.budget) == ("fabric", 1)
        out = port_serve.run(args)
        assert isinstance(out["incidents"], list)
        assert all(a["tick"] in (1, 2) for a in out["escalations"])
        assert len(out["escalations"]) <= 2
        with pytest.raises(SystemExit):
            port_serve.make_argparser().parse_args(["--topology", "mesh"])

    def test_no_topology_has_no_incident_output(self, default_runs):
        _, port = default_runs
        assert "incidents" not in port and "escalations" not in port


def _packet(seed, cls=EvidencePacket, stages=("s0", "s1", "s2"), steps=6,
            ranks=5):
    rng = np.random.default_rng(seed)
    return cls(
        window_index=0, schema_hash="h", stages=stages, steps=steps,
        world_size=ranks, gather_ok=True, labels=(), routing_stages=stages[:1],
        shares=(1.0,) + (0.0,) * (len(stages) - 1),
        gains=(0.0,) * len(stages), co_critical_stages=(),
        downgrade_reasons=(), leader_rank=0, exposed_total=1.0,
        window=rng.exponential(0.02, size=(steps, ranks, len(stages))),
        sync_stages=stages[1:2],
    )


def _refreshed(service, fused=None, cls=EvidencePacket):
    """Submit three jobs' packets and refresh; returns the jobs by id."""
    service.submit_many([(f"j{i}", _packet(i, cls)) for i in range(3)])
    service.refresh_batched(fused=fused)
    return {j.job_id: j for j in service.registry.jobs()}


class TestFourDispatchRoute:
    """`FleetService(fused=False)`: the four-dispatch reference route,
    against the JAX package's and against the port's fused route."""

    @pytest.fixture(scope="class")
    def four_dispatch_runs(self):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_serve, "FleetService",
                       functools.partial(ref_serve.FleetService, fused=False))
            mp.setattr(port_serve, "FleetService",
                       functools.partial(FleetService, fused=False))
            return _runs()

    def test_four_dispatch_route_serves_as_the_fused_route(
        self, four_dispatch_runs, default_runs
    ):
        ref, port = four_dispatch_runs
        _assert_routes_agree(ref, port)
        assert port["snapshot"] == ref["snapshot"]
        # the port's two routes: identical answers
        assert port["routing"] == default_runs[1]["routing"]
        assert port["snapshot"] == default_runs[1]["snapshot"]

    def test_service_flag(self):
        assert FleetService(device="cpu", fused=False).fused is False
        assert FleetService(device="cpu").fused is True

    def test_refresh_batched_route_argument(self):
        """`refresh_batched(fused=False)` on a fused service equals its
        fused refresh bit for bit, and the reference's four-dispatch
        refresh within the service tolerance."""
        from repro.fleet import FleetService as RefService
        from repro.telemetry.packets import EvidencePacket as RefPacket

        four = _refreshed(FleetService(device="cpu"), fused=False)
        one = _refreshed(FleetService(device="cpu", fused=False), fused=True)
        ref = _refreshed(RefService(), fused=False, cls=RefPacket)
        assert sorted(four) == sorted(one) == sorted(ref) == ["j0", "j1", "j2"]
        for job_id, job in four.items():
            np.testing.assert_array_equal(job.whatif, one[job_id].whatif)
            np.testing.assert_array_equal(job.kernel_shares, one[job_id].kernel_shares)
            np.testing.assert_array_equal(job.kernel_gains, one[job_id].kernel_gains)
            assert job.kernel_leader == one[job_id].kernel_leader == ref[job_id].kernel_leader
            np.testing.assert_allclose(job.whatif, ref[job_id].whatif, rtol=RTOL, atol=1e-7)
            np.testing.assert_allclose(
                job.kernel_shares, ref[job_id].kernel_shares, rtol=RTOL, atol=1e-7
            )


#: summary fields that carry wall-clock state
_WALL_CLOCK = ("ingest_jobs_per_second", "obs")


class TestShards:
    @pytest.mark.parametrize("topology", ["none", "fabric"])
    def test_sharded_serve_equals_unsharded(self, topology):
        """`--shards 3 --device cpu`: the same summary as the unsharded
        run outside the wall-clock fields, and `"shards": 3`."""
        argv = ARGV + ["--topology", topology, "--device", "cpu"]
        one = port_serve.run(port_serve.make_argparser().parse_args(argv))
        three = port_serve.run(port_serve.make_argparser().parse_args(
            argv + ["--shards", "3"]
        ))
        assert (one["shards"], three["shards"]) == (0, 3)
        for out in (one, three):
            for key in _WALL_CLOCK + ("shards",):
                out.pop(key)
        assert three == one
        assert three["routing"]
