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


class TestNotYetPorted:
    def test_incidents_raise(self):
        with pytest.raises(NotImplementedError, match="slice 2"):
            FleetService(device="cpu", incidents=object())

    def test_four_dispatch_route_raises(self):
        with pytest.raises(NotImplementedError, match="slice 2"):
            FleetService(device="cpu", fused=False)

    def test_topology_flag_accepts_only_none(self):
        with pytest.raises(SystemExit):
            port_serve.make_argparser().parse_args(["--topology", "shared"])
        args = argparse.Namespace(topology="shared")
        with pytest.raises(NotImplementedError, match="slice 2"):
            port_serve.run(args)
