"""The dry run's analysis: roofline terms from op counts (`roofline`),
its tables (`report`) and the merge of two runs' rows (`merge_runs`)."""
from .roofline import CellCosts, OpCounter, RooflineReport, model_flops, roofline

__all__ = ["CellCosts", "OpCounter", "RooflineReport", "model_flops", "roofline"]
