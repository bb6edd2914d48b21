"""Hand-written CUDA kernels (Hopper, sm_90a): the fleet tick's, the
models' causal attention and the SSD scan.

frontier/ — `csrc/` holds the kernels: the fused fleet tick
(`fused_tick.cu`), the three single-family kernels of the four-dispatch
reference route (`frontier_window.cu`, `whatif_matrix.cu`,
`regime_stats.cu`) and the incident tier's co-activation count
(`coactivation.cu`).  Beside them: `fused.py` (the fused wrapper, its
plain PyTorch version, the epilog and `four_dispatch_tick`),
`frontier.py` (the single-family wrappers and their plain versions),
`incidents.py` (co-activation), `ops.py` (packet types, the shared
prolog and epilogs, the single-family routes, the sources' directory and
flags) and `ref.py` (plain-torch oracles).

attention/ — `csrc/causal_attention.cu`, the causal attention that
`models.attention.chunked_causal_attention` runs on CUDA tensors, and
`causal.py`, its wrapper and the plain version of its arithmetic.

ssd/ — `csrc/ssd_scan.cu`, the Mamba-2 SSD chunked scan that
`models.ssm._ssd` runs on CUDA tensors, and `scan.py`, its wrapper and
the plain version of its arithmetic.

`_lib.py` builds and loads every kernel library of the port.
"""
