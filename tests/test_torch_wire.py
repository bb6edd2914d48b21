"""The PyTorch port's wire format against the reference package.

A fleet may mix emitters running either package, so the port's
`telemetry.packets` must decode every checked-in golden fixture
(`tests/golden/*.bin`: SFP1, SFP2 v1/v2/v3, int8, int8.delta) to the
same arrays and headers as `repro.telemetry.packets`, re-encode them
byte for byte, and exchange freshly encoded packets in both directions.
"""
import dataclasses
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.distributed import compression as ref_codec  # noqa: E402
from repro.telemetry import packets as ref  # noqa: E402
from repro_torch.distributed import compression as port_codec  # noqa: E402
from repro_torch.fleet import FleetIngest  # noqa: E402
from repro_torch.telemetry import packets as port  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"

#: fixture -> (compress, wire) it was encoded with
GOLDEN = {
    "sfp1_f64.bin": ("none", "sfp1"),
    "sfp1_int8.bin": ("int8", "sfp1"),
    "sfp1_compact.bin": ("none", "sfp1"),
    "sfp2_v1_f64.bin": ("none", "sfp2"),
    "sfp2_v1_delta.bin": ("int8.delta", "sfp2"),
    "sfp2_v2_hosts.bin": ("int8", "sfp2"),
    "sfp2_v3_fabric.bin": ("none", "sfp2"),
    "sfp2_v3_fabric_int8.bin": ("int8", "sfp2"),
}


def _assert_same(a, b) -> None:
    """Field-by-field equality of two packets from either package."""
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for name in names:
        if name == "window":
            continue
        assert getattr(a, name) == getattr(b, name), name
    if a.window is None:
        assert b.window is None
    else:
        np.testing.assert_array_equal(np.asarray(a.window), np.asarray(b.window))
        assert np.asarray(a.window).dtype == np.asarray(b.window).dtype


def _convert(pkt, module):
    """The same packet as the other package's EvidencePacket."""
    return module.EvidencePacket(
        **{f.name: getattr(pkt, f.name) for f in dataclasses.fields(pkt)}
    )


def _packet(module, *, window=True, tiers=0):
    """A deterministic packet (integer arithmetic, no RNG)."""
    n, r, s = 6, 8, 4
    w = None
    if window:
        cells = np.arange(n * r * s, dtype=np.float64).reshape(n, r, s)
        w = (cells % 97.0) * 0.013 + (cells % 7.0) * 1e-4
    kw = {}
    if tiers >= 1:
        kw["hosts"] = tuple(f"host-{i // 2}" for i in range(r))
    if tiers >= 3:
        kw["switches"] = tuple(f"sw-{i // 4}" for i in range(r))
        kw["pods"] = tuple("pod-0" for _ in range(r))
    return module.EvidencePacket(
        window_index=7, schema_hash="0123456789abcdef",
        stages=tuple(f"stage.{i}" for i in range(s)), steps=n, world_size=r,
        gather_ok=True, labels=("frontier_accounting",),
        routing_stages=("stage.2",), shares=(0.4, 0.3, 0.2, 0.1),
        gains=(0.05, 0.0, 0.0, 0.0), co_critical_stages=(),
        downgrade_reasons=(), leader_rank=5,
        present_ranks=tuple(range(r)), exposed_total=3.5,
        sync_stages=("stage.1",), first_step=42, window=w, **kw,
    )


class TestGoldenFixtures:
    @pytest.mark.parametrize("name", sorted(GOLDEN))
    def test_decode_matches_reference(self, name):
        blob = (GOLDEN_DIR / name).read_bytes()
        _assert_same(port.decode_packet(blob), ref.decode_packet(blob))

    @pytest.mark.parametrize("name", sorted(GOLDEN))
    def test_reencode_is_byte_identical(self, name):
        blob = (GOLDEN_DIR / name).read_bytes()
        compress, wire = GOLDEN[name]
        got = port.decode_packet(blob)
        assert port.encode_packet(got, compress=compress, wire=wire) == blob


class TestCrossPackage:
    @pytest.mark.parametrize("compress", ["none", "int8", "int8.delta"])
    @pytest.mark.parametrize("tiers", [0, 1, 3])
    def test_both_directions(self, compress, tiers):
        ref_pkt = _packet(ref, tiers=tiers)
        port_pkt = _packet(port, tiers=tiers)
        ref_wire = ref.encode_packet(ref_pkt, compress=compress)
        port_wire = port.encode_packet(port_pkt, compress=compress)
        assert ref_wire == port_wire
        _assert_same(port.decode_packet(ref_wire), ref.decode_packet(ref_wire))
        _assert_same(ref.decode_packet(port_wire), port.decode_packet(port_wire))

    @pytest.mark.parametrize("compress", ["none", "int8"])
    def test_sfp1_both_directions(self, compress):
        ref_wire = ref.encode_packet(_packet(ref), compress=compress, wire="sfp1")
        port_wire = port.encode_packet(
            _packet(port), compress=compress, wire="sfp1"
        )
        assert ref_wire == port_wire
        _assert_same(port.decode_packet(ref_wire), ref.decode_packet(ref_wire))

    def test_compact_packet_converts(self):
        pkt = _packet(ref, window=False)
        wire = port.encode_packet(_convert(pkt, port))
        _assert_same(ref.decode_packet(wire), pkt)

    def test_port_ingest_reads_reference_packets(self):
        ingest = FleetIngest()
        wires = [
            ref.encode_packet(_packet(ref), compress=c)
            for c in ("none", "int8", "int8.delta")
        ]
        decoded = ingest.decode_many(wires + [b"garbage"])
        assert [p is None for p in decoded] == [False, False, False, True]
        assert ingest.stats.decode_errors == 1


class TestCodecs:
    @pytest.mark.parametrize("axis", [None, -1])
    def test_quantize_matches(self, axis):
        x = np.random.default_rng(0).normal(size=(5, 7, 4))
        qr, sr = ref_codec.quantize_i8(x, axis=axis)
        qp, sp = port_codec.quantize_i8(x, axis=axis)
        np.testing.assert_array_equal(qp, qr)
        np.testing.assert_array_equal(sp, sr)
        np.testing.assert_array_equal(
            port_codec.dequantize_i8(qp, sp, axis=axis),
            ref_codec.dequantize_i8(qr, sr, axis=axis),
        )

    def test_delta_varint_matches(self):
        q = np.random.default_rng(1).integers(-127, 128, (9, 6, 4)).astype(np.int8)
        blob = port_codec.delta_varint_encode_i8(q)
        assert blob == ref_codec.delta_varint_encode_i8(q)
        np.testing.assert_array_equal(
            port_codec.delta_varint_decode_i8(blob, q.shape), q
        )
