from .fused import FusedTickPacket, TickInputs, fused_fleet_tick, tick_inputs
from .incidents import (
    TierAxes,
    co_activation,
    co_activation_loop,
    co_activation_ref,
    tiered_co_activation,
    tiered_co_activation_ref,
)
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
    "TierAxes",
    "co_activation",
    "co_activation_loop",
    "co_activation_ref",
    "fused_fleet_tick",
    "tick_inputs",
    "tiered_co_activation",
    "tiered_co_activation_ref",
]
