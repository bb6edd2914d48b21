"""StageFrontier on PyTorch and CUDA: the fleet service tick.

A port of the `repro` package's fleet serving path to PyTorch, with its
kernels written by hand in CUDA C++ for Hopper (sm_90a).  It imports
nothing of `repro` and never imports JAX: the NumPy modules it needs are
its own copies, laid out as in `repro` (core/, telemetry/, obs/, sim/,
fleet/, incidents/, kernels/frontier/, replay/, launch/) so each
counterpart is easy to find.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
