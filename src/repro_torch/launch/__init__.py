"""Launchers: the fleet serving driver."""
