"""Fleet wire ingest: failure-safe evidence-packet decoding.

The fleet boundary is hostile by construction — thousands of jobs ship
packets over flaky transports, versions skew, payloads truncate.  The
ingest layer applies the same contract as the telemetry gather (§5):
malformed input is *counted and dropped*, never raised into the service
loop.  Both wire framings are accepted (SFP2 and the legacy SFP1), in
raw float64, per-stage int8, and int8 delta+varint payload codecs — the
codecs shared with `repro.distributed.compression`.

`decode_many` is the batched tick path: one call decodes a whole tick's
wire blobs and feeds `FleetService.submit_many` -> `refresh_batched`
without intermediate copies — SFP2 float64 windows land as read-only
zero-copy views into their wire buffers and are only materialized once,
by the registry's single `float32` cast for the batched kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from ..telemetry.packets import EvidencePacket, decode_packet

__all__ = ["FleetIngest", "IngestStats"]


@dataclasses.dataclass
class IngestStats:
    """Wire-boundary counters.

    `packets` counts every accepted submission; `predecoded` is the
    subset that arrived as in-process `EvidencePacket` objects (no wire
    bytes — same-process emitters).  `bytes` only ever counts real wire
    bytes, so `avg_wire_bytes` stays a transport number instead of being
    dragged toward zero by pre-decoded submissions.
    """

    packets: int = 0
    bytes: int = 0
    decode_errors: int = 0
    #: accepted submissions that were already-decoded EvidencePackets
    predecoded: int = 0

    @property
    def wire_packets(self) -> int:
        """Accepted packets that actually crossed the wire."""
        return self.packets - self.predecoded

    @property
    def error_ratio(self) -> float:
        """Decode failures per wire submission.  Pre-decoded packets never
        touch the decoder, so they are excluded — 90 in-process
        submissions must not dilute 10 bad blobs out of 20 wire packets
        down from 50% to 9%."""
        total = self.wire_packets + self.decode_errors
        return self.decode_errors / total if total else 0.0

    @property
    def avg_wire_bytes(self) -> float:
        """Mean wire size of decoded packets (0.0 before any arrive)."""
        wp = self.wire_packets
        return self.bytes / wp if wp else 0.0


class FleetIngest:
    """Stateless decoder with drop counters (the fleet's gather contract)."""

    def __init__(self):
        self.stats = IngestStats()

    def decode(self, data: bytes | EvidencePacket) -> EvidencePacket | None:
        """Decode one wire payload; returns None (and counts) on any error."""
        if isinstance(data, EvidencePacket):
            self.stats.packets += 1
            self.stats.predecoded += 1
            return data
        try:
            pkt = decode_packet(bytes(data))
        except Exception:
            self.stats.decode_errors += 1
            return None
        self.stats.packets += 1
        self.stats.bytes += len(data)
        return pkt

    def decode_many(
        self, blobs: Iterable[bytes | EvidencePacket]
    ) -> list[EvidencePacket | None]:
        """Decode a tick's worth of payloads, position-aligned with the
        input (None where a blob was dropped); counters update exactly as
        `decode` would."""
        return [self.decode(b) for b in blobs]
