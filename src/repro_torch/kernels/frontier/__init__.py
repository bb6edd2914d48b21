from .fused import FusedTickPacket, TickInputs, fused_fleet_tick, tick_inputs
from .ops import (
    CoActivationPacket,
    FleetPacket,
    FleetRegimePacket,
    FleetWhatIfPacket,
)

__all__ = [
    "CoActivationPacket",
    "FleetPacket",
    "FleetRegimePacket",
    "FleetWhatIfPacket",
    "FusedTickPacket",
    "TickInputs",
    "fused_fleet_tick",
    "tick_inputs",
]
