"""Hand-written CUDA kernels for the fleet tick (Hopper, sm_90a).

frontier/ — the fused fleet tick: `csrc/fused_tick.cu` (the kernel),
`fused.py` (wrapper, plain PyTorch version, prolog and epilog) and
`ops.py` (packet types and the torch prolog helpers).
"""
