"""The PyTorch port's fleet service against the reference, on CPU.

`repro.launch.serve_fleet.run` and `repro_torch.launch.serve_fleet.run`
(`--device cpu`: the tick kernel's plain torch version) serve the same
simulated fleet.  Their routes must name the same (job, stage, rank,
regime) with `recoverable_s` within rtol 1e-4, and their snapshots must
agree apart from the wall-clock `obs` section.
"""
import argparse

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve_fleet as ref_serve  # noqa: E402
from repro_torch.fleet import FleetService  # noqa: E402
from repro_torch.incidents import IncidentEngine  # noqa: E402
from repro_torch.kernels.frontier import fused  # noqa: E402
from repro_torch.launch import serve_fleet as port_serve  # noqa: E402

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


class TestNotYetPorted:
    def test_four_dispatch_route_raises(self):
        with pytest.raises(NotImplementedError, match="slice 2"):
            FleetService(device="cpu", fused=False)

    def test_shards_raise(self):
        args = argparse.Namespace(topology="none", shards=2)
        with pytest.raises(NotImplementedError, match="slice 3"):
            port_serve.run(args)
