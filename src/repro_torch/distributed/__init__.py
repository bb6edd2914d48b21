"""Distribution: sharding plans, tensor-parallel compute
(`tensor_parallel`), operational policy, gradient compression (and the
telemetry wire codecs in `compression`)."""
from .compression import EFState, compress_grads, init_ef
from .policy import Action, MonitorPolicy
from .sharding import BASELINE_PLAN, DECODE_PLAN, ShardingPlan, tree_shardings

__all__ = [
    "Action",
    "BASELINE_PLAN",
    "DECODE_PLAN",
    "EFState",
    "MonitorPolicy",
    "ShardingPlan",
    "compress_grads",
    "init_ef",
    "tree_shardings",
]
