"""Launchers: the fleet serving driver and the trace replay driver."""
