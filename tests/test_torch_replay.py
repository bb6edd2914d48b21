"""The PyTorch port's trace replay against the reference, on CPU.

`repro.replay` and `repro_torch.replay` load the same traces and replay
them through their fleet services (`device="cpu"` on the port: the tick
kernels' plain torch versions).  Reports must agree outside the
wall-clock fields (`elapsed_s`, `windows_per_s`, `obs`): integers and
strings exactly, floats within rtol 1e-4, the service tests' tolerance
for the float sums a report carries.  The port's fused and four-dispatch
replays must be identical outside those fields, and the loaders must
count the same skips for the same malformed rows.
"""
import json
from dataclasses import asdict

import pytest

torch = pytest.importorskip("torch")

from repro.launch import replay as ref_cli  # noqa: E402
from repro.replay import generate_trace as ref_generate  # noqa: E402
from repro.replay import parse_trace as ref_parse  # noqa: E402
from repro.replay import replay_trace as ref_replay  # noqa: E402
from repro_torch.launch import replay as port_cli  # noqa: E402
from repro_torch.replay import TRACE_VERSION, generate_trace, load_trace  # noqa: E402
from repro_torch.replay import parse_trace, replay_trace  # noqa: E402

RTOL = 1e-4
#: report fields that carry wall-clock state
_WALL_CLOCK = ("elapsed_s", "windows_per_s", "obs")

SMALL = dict(jobs=4, ticks=6, window_steps=5, world_size=6, seed=0)
SWITCH = dict(jobs=4, ticks=6, window_steps=8, world_size=8, seed=0,
              fault_every=3, shared_switch=True)
SFP1 = dict(jobs=3, ticks=4, window_steps=8, world_size=8, seed=2,
            elastic=False, hosts=False)


def _report(rep) -> dict:
    out = rep.as_dict() if hasattr(rep, "as_dict") else dict(rep)
    for key in _WALL_CLOCK:
        out.pop(key, None)
    return out


def _assert_same(got, want, path="report"):
    """Equal structure and values; floats within RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=RTOL, abs=1e-9), path
    else:
        assert got == want, path


def _replays(params, **kw):
    """(port, reference) reports of the same generated trace."""
    text = generate_trace(**params)
    assert text == ref_generate(**params)
    port = replay_trace(parse_trace(text, name="t"), device="cpu", **kw)
    ref = ref_replay(ref_parse(text, name="t"), **kw)
    return _report(port), _report(ref)


@pytest.fixture(scope="module")
def small_four_dispatch():
    return _replays(SMALL, fused=False)


class TestReplayAgainstReference:
    def test_four_dispatch_replay(self, small_four_dispatch):
        port, ref = small_four_dispatch
        assert port["windows_replayed"] > 0 and port["scored_windows"] > 0
        _assert_same(port, ref)

    def test_fused_replay(self):
        _assert_same(*_replays(SMALL, fused=True))

    def test_fused_and_four_dispatch_reports_identical(self, small_four_dispatch):
        text = generate_trace(**SMALL)
        fused = _report(replay_trace(parse_trace(text, name="t"), device="cpu"))
        assert fused == small_four_dispatch[0]

    @pytest.mark.parametrize("fused", [True, False])
    def test_shared_switch_incident(self, fused):
        port, ref = _replays(SWITCH, incidents=True, fused=fused)
        _assert_same(port, ref)
        fleet = [r for r in port["incidents"] if r["scope"] == "fleet"]
        assert [(r["tier"], r["host"]) for r in fleet] == [("switch", "fab-sw0")]

    def test_sfp1_wire(self):
        port, ref = _replays(SFP1, fused=False, wire="sfp1", compress="none")
        _assert_same(port, ref)
        assert port["windows_replayed"] == 3 * 4

    def test_default_trace_four_dispatch(self):
        """The generator's default 12 jobs x 16 ticks x 8 steps x 8 ranks."""
        port, ref = _replays({}, fused=False)
        _assert_same(port, ref)
        assert port["resizes"] and port["departures"] and port["rearrivals"]


class TestLoaderAgainstReference:
    """The loader's counted skips on the malformed rows of the reference's
    own loader tests, row by row and file by file."""

    def row(self, **kw):
        return json.dumps({"v": TRACE_VERSION, **kw})

    def _same_parse(self, text):
        got, want = parse_trace(text), ref_parse(text)
        assert asdict(got.stats) == asdict(want.stats)
        assert [asdict(e) for e in got.events] == [asdict(e) for e in want.events]
        assert (got.name, got.ticks, got.window_steps) == (
            want.name, want.ticks, want.window_steps)
        return got

    def test_each_malformation_is_a_counted_skip(self):
        good = self.row(kind="arrive", tick=0, job_id="j", world_size=2,
                        stages=["a", "b"], sync_stages=[], seed=1)
        bad = [
            "{not json",
            '"a bare string"',
            json.dumps({"v": 99, "kind": "depart", "tick": 0, "job_id": "j"}),
            self.row(kind="nope", tick=0, job_id="j"),
            self.row(kind="depart", tick=0, job_id=""),
            self.row(kind="depart", tick=-1, job_id="j"),
            self.row(kind="arrive", tick=0, job_id="j", world_size=2, stages=[]),
            self.row(kind="arrive", tick=0, job_id="j", world_size=2,
                     stages=["a"], sync_stages=["zz"]),
            self.row(kind="arrive", tick=0, job_id="j", world_size=2,
                     stages=["a"], hosts=["h0"]),
            self.row(kind="arrive", tick=0, job_id="j", world_size=2,
                     stages=["a"], tasks=[{"role": "worker", "ranks": [0]},
                                          {"role": "ps", "ranks": [0]}]),
            self.row(kind="arrive", tick=0, job_id="j", world_size=2,
                     stages=["a"], tasks=[{"role": "astronaut", "ranks": [0]}]),
            self.row(kind="fault", tick=0, job_id="j", family="gremlins",
                     rank=0, delay_ms=5),
            self.row(kind="fault", tick=0, job_id="j", family="data",
                     rank=0, delay_ms=-5),
            self.row(kind="fault", tick=3, job_id="j", family="data",
                     rank=0, delay_ms=5, until_tick=2),
        ]
        tr = self._same_parse("\n".join([good] + bad))
        assert tr.stats.accepted == 1 and tr.stats.skipped == len(bad) + 1
        for line in bad:
            self._same_parse(line)

    def test_tiered_placement_validation(self):
        good = self.row(kind="arrive", tick=0, job_id="j", world_size=2,
                        stages=["a"], hosts=["h0", "h1"],
                        switches=["s0", "s0"], pods=["p0", "p0"])
        bad = [
            self.row(kind="arrive", tick=0, job_id="k", world_size=2,
                     stages=["a"], switches=["s0", "s0"]),
            self.row(kind="arrive", tick=0, job_id="k", world_size=2,
                     stages=["a"], hosts=["h0", "h1"], switches=["s0"]),
            self.row(kind="arrive", tick=0, job_id="k", world_size=2,
                     stages=["a"], hosts=["h0", "h1"], pods=["p0", "p0"]),
            self.row(kind="resize", tick=1, job_id="j", world_size=2,
                     hosts=["h0", "h1"], switches=["s0", "s0"], pods=["p0"]),
        ]
        tr = self._same_parse("\n".join([good] + bad))
        assert tr.stats.skip_reasons["bad_switches"] == 2
        assert tr.stats.skip_reasons["bad_pods"] == 2

    def test_meta_rows_and_empty_input(self):
        meta = json.dumps({"v": 1, "kind": "meta", "name": "x",
                           "window_steps": 4, "ticks": 2})
        self._same_parse("\n".join([meta, meta]))
        self._same_parse(self.row(kind="depart", tick=5, job_id="j"))
        self._same_parse(self.row(kind="arrive", tick=0, job_id="j",
                                  world_size=2, stages=["a"], hosts=["h0", "h1"]))
        self._same_parse("")
        self._same_parse("\n\n  \n")

    def test_every_offset_truncation_and_corruption(self):
        raw = generate_trace(jobs=4, ticks=6, window_steps=4, world_size=4,
                             seed=1).encode()
        for cut in range(0, len(raw) + 1, 7):
            self._same_parse(raw[:cut].decode("utf-8", errors="replace"))
        for off in range(0, len(raw), 29):
            damaged = bytearray(raw)
            damaged[off] ^= 0xFF
            self._same_parse(bytes(damaged).decode("utf-8", errors="replace"))

    def test_truncated_file_replays_with_reported_skips(self, tmp_path):
        raw = generate_trace(jobs=3, ticks=4, window_steps=4, world_size=4,
                             seed=1).encode()
        path = tmp_path / "cut.jsonl"
        path.write_bytes(raw[:-20])
        tr = load_trace(path)
        assert tr.stats.skipped >= 1
        rep = replay_trace(tr, device="cpu", fused=False)
        assert rep.loader["skip_reasons"] == ref_replay(
            ref_parse(raw[:-20].decode())).loader["skip_reasons"]


class TestReplayCli:
    ARGV = ["--synth", "--jobs", "3", "--ticks", "4", "--ranks", "8",
            "--tick-path", "four-dispatch"]

    def test_run_against_reference(self, tmp_path):
        saved = tmp_path / "synth.jsonl"
        port = port_cli.run(port_cli.make_argparser().parse_args(
            self.ARGV + ["--device", "cpu", "--save-trace", str(saved)]
        ))
        ref = ref_cli.run(ref_cli.make_argparser().parse_args(self.ARGV))
        assert port["tick_path"] == "four-dispatch" and port["shards"] == 0
        _assert_same(_report(port), _report(ref))
        again = port_cli.run(port_cli.make_argparser().parse_args(
            ["--trace", str(saved), "--tick-path", "four-dispatch",
             "--device", "cpu"]
        ))
        assert again["windows_replayed"] == port["windows_replayed"]

    @pytest.mark.parametrize("workers", ["thread", "inline"])
    def test_sharded_replay_equals_unsharded(self, workers):
        """`--shards 3`: the same report as the unsharded replay outside
        the wall-clock fields, on the four-dispatch route and with the
        incident tier at the coordinator."""
        argv = ["--synth", "--jobs", "4", "--ticks", "6", "--window", "8",
                "--ranks", "8", "--tick-path", "four-dispatch", "--incidents",
                "--shared-switch", "--device", "cpu"]
        one = port_cli.run(port_cli.make_argparser().parse_args(argv))
        three = port_cli.run(port_cli.make_argparser().parse_args(
            argv + ["--shards", "3", "--shard-workers", workers]
        ))
        assert (one["shards"], three["shards"]) == (0, 3)
        one.pop("shards"), three.pop("shards")
        assert _report(three) == _report(one)
        assert any(r["scope"] == "fleet" for r in three["incidents"])

    def test_device_flag(self):
        parser = port_cli.make_argparser()
        assert parser.parse_args(["--synth"]).device == "cuda"
        with pytest.raises(SystemExit):
            parser.parse_args(["--synth", "--device", "tpu"])
