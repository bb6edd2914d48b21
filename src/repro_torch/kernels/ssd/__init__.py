"""The port's SSD kernels for the card: the chunked scan (`ssd_scan`) and
the mixer's two elementwise chains around it (`conv_silu_dt`,
`gated_rms_norm`), each with the plain version of its arithmetic."""
from .mixer import ProjGrad, conv_silu_dt, conv_silu_dt_ref, gated_rms_norm, gated_rms_norm_ref
from .scan import INSTANCES, launches, library_flags, ssd_scan, ssd_scan_ref

__all__ = ["INSTANCES", "ProjGrad", "conv_silu_dt", "conv_silu_dt_ref", "gated_rms_norm",
           "gated_rms_norm_ref", "launches", "library_flags", "ssd_scan", "ssd_scan_ref"]
