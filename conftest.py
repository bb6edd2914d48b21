"""The CPU-thread budget of every test process.

Each process that runs tests gets an equal share of the cores it may use:
``share = max(1, cores // workers)``, where ``cores`` is the process's
affinity mask and ``workers`` is pytest-xdist's worker count (1 without
xdist).  The share goes into ``OMP_NUM_THREADS`` before any test module
imports torch, so torch's intra-op pool takes it and every process a test
starts inherits it.

Why: torch's pool is as wide as the machine by default.  Under ``-n 6`` on
8 cores that is 48 threads waiting on each other, on tests whose models
have 2 layers of width 64.  ``tests/test_torch_attention_kernel.py`` runs in
9.4 s alone and took 1,021.6 s of a ``-n 6 --dist loadfile`` run of the
whole suite.  Eight of the heaviest files take 684 s of wall time under
``-n 6`` with the default pool and 200 s at one thread a worker (8 cores).

- An xdist worker always sets its share: the controller's environment,
  which it inherits, says nothing about how many siblings it has.
- The xdist controller runs no test and sets nothing.
- A run without xdist keeps an ``OMP_NUM_THREADS`` the caller set.

Tests that start several ranks at once from one process still pin each
rank to one thread themselves: the ranks share that process's share.
"""
import os
import sys


def pytest_configure(config):
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if worker is None and (getattr(config.option, "numprocesses", None)
                           or "OMP_NUM_THREADS" in os.environ):
        return
    workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"]) if worker else 1
    share = max(1, len(os.sched_getaffinity(0)) // workers)
    os.environ["OMP_NUM_THREADS"] = str(share)
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(share)
