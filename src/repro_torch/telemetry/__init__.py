"""Telemetry wire format and stage recorder.

Only the packet codec and the recorder live here: the per-job monitor
(collector, gather, device events) is not part of this package yet.
"""
from .packets import EvidencePacket, decode_packet, encode_packet
from .recorder import StageRecorder, StepRecord

__all__ = [
    "EvidencePacket",
    "StageRecorder",
    "StepRecord",
    "decode_packet",
    "encode_packet",
]
