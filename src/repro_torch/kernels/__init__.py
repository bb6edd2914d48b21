"""Hand-written CUDA kernels for the fleet tick (Hopper, sm_90a).

frontier/ — `csrc/` holds the kernels: the fused fleet tick
(`fused_tick.cu`), the three single-family kernels of the four-dispatch
reference route (`frontier_window.cu`, `whatif_matrix.cu`,
`regime_stats.cu`) and the incident tier's co-activation count
(`coactivation.cu`).  Beside them: `fused.py` (the fused wrapper, its
plain PyTorch version, the epilog and `four_dispatch_tick`),
`frontier.py` (the single-family wrappers and their plain versions),
`incidents.py` (co-activation), `ops.py` (packet types, the shared
prolog and epilogs, the single-family routes) and `ref.py` (plain-torch
oracles).
"""
