"""Synchronization-displacement simulator (hidden-rank evaluation substrate)."""
from .cluster import ClusterSpec, Fault, Scenario, SimResult, simulate
from . import scenarios

__all__ = [
    "ClusterSpec",
    "Fault",
    "Scenario",
    "SimResult",
    "simulate",
    "scenarios",
]
