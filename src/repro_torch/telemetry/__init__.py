"""Always-on telemetry runtime: recorder, device-timed regions, device
events, gather, packets, and the per-job `Monitor` that wires them to the
window labeler."""
from .collector import Monitor
from .device_events import DeviceEventChannel
from .gather import (
    GatherResult,
    InProcTransport,
    TelemetryGather,
    TorchDistTransport,
)
from .packets import EvidencePacket, decode_packet, encode_packet
from .recorder import SideValues, StageRecorder, StepRecord
from .regions import timed_regions

__all__ = [
    "DeviceEventChannel",
    "EvidencePacket",
    "Monitor",
    "GatherResult",
    "InProcTransport",
    "SideValues",
    "StageRecorder",
    "StepRecord",
    "TelemetryGather",
    "TorchDistTransport",
    "decode_packet",
    "encode_packet",
    "timed_regions",
]
