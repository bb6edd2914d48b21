"""The port's SSD chunked scan for the card (`ssd_scan`) and the plain
version of its arithmetic (`ssd_scan_ref`)."""
from .scan import INSTANCES, launches, library_flags, ssd_scan, ssd_scan_ref

__all__ = ["INSTANCES", "launches", "library_flags", "ssd_scan", "ssd_scan_ref"]
