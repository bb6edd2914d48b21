"""Distribution helpers: the telemetry wire codecs (`compression`) and the
monitor's operational policy (`policy`)."""
from .policy import Action, MonitorPolicy

__all__ = ["Action", "MonitorPolicy"]
