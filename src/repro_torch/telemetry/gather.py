"""Failure-safe telemetry gather (paper §5).

A window-boundary collective gathers each rank's [N, S] stage buffer to
rank 0.  The transport is pluggable:

  InProcTransport      threads/simulation transport with injectable
                       failures and timeouts (tests, routing matrices)
  TorchDistTransport   live multi-process gather over an initialised
                       `torch.distributed` group (all_gather of a tiny
                       buffer; CUDA tensors under NCCL, CPU under Gloo)

Contract: a failed or timed-out gather records gather_ok=false, emits any
safe local summary, downgrades distributed labels to telemetry_limited, and
NEVER fails training.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from datetime import timedelta
from typing import Protocol

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "GatherResult",
    "InProcTransport",
    "TorchDistTransport",
    "TelemetryGather",
]


@dataclasses.dataclass(frozen=True)
class GatherResult:
    ok: bool
    #: [N, R, S] on success (root view); None on failure.
    window: np.ndarray | None
    present_ranks: tuple[int, ...]
    elapsed_s: float
    error: str = ""
    #: per-rank [N, S] buffers (None for missing ranks) — the safe partial
    #: view used for degraded local summaries.
    parts: tuple[np.ndarray | None, ...] = ()


class Transport(Protocol):
    def allgather(self, rank: int, local: np.ndarray, timeout_s: float) -> list[np.ndarray | None]:
        ...


class InProcTransport:
    """Deterministic in-process transport for R simulated ranks.

    Failure injection: `fail_ranks` never contribute; `slow_ranks` contribute
    after `slow_delay_s` (exceeding the timeout drops them).
    """

    def __init__(
        self,
        world_size: int,
        *,
        fail_ranks: frozenset[int] = frozenset(),
        slow_ranks: frozenset[int] = frozenset(),
        slow_delay_s: float = 0.0,
    ):
        self.world_size = world_size
        self.fail_ranks = frozenset(fail_ranks)
        self.slow_ranks = frozenset(slow_ranks)
        self.slow_delay_s = slow_delay_s
        self._lock = threading.Lock()
        self._boxes: dict[int, np.ndarray] = {}

    def deposit(self, rank: int, local: np.ndarray) -> None:
        with self._lock:
            self._boxes[rank] = np.asarray(local)

    def allgather(self, rank: int, local: np.ndarray, timeout_s: float) -> list[np.ndarray | None]:
        self.deposit(rank, local)
        out: list[np.ndarray | None] = []
        for r in range(self.world_size):
            if r in self.fail_ranks:
                out.append(None)
            elif r in self.slow_ranks and self.slow_delay_s > timeout_s:
                out.append(None)  # timed out
            else:
                with self._lock:
                    out.append(self._boxes.get(r, local if r == rank else None))
        return out


class TorchDistTransport:
    """Live multi-process transport over an initialised `torch.distributed`
    group (one rank per process).

    Gathers the [N, S] float64 window with an asynchronous `all_gather`
    and waits at most `timeout_s` for it: on NCCL the buffers are CUDA
    tensors on this rank's device, on Gloo CPU tensors.  Any exception or
    timeout — a rank that never calls, a group already destroyed — is
    converted into a failed gather (never raised into the train loop).
    """

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError(
                "TorchDistTransport: torch.distributed is not initialised "
                "(call init_process_group first)"
            )
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = (
            torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl"
            else torch.device("cpu")
        )

    def allgather(self, rank: int, local: np.ndarray, timeout_s: float) -> list[np.ndarray | None]:
        try:
            t = torch.from_numpy(np.array(local, np.float64)).to(self.device)
            bufs = [torch.empty_like(t) for _ in range(self.world_size)]
            work = dist.all_gather(bufs, t, async_op=True)
            work.wait(timeout=timedelta(seconds=timeout_s))
            return [b.cpu().numpy() for b in bufs]
        except Exception:
            return [local if r == rank else None for r in range(self.world_size)]


class TelemetryGather:
    """Window-boundary gather with the failure-safe contract."""

    def __init__(self, transport, rank: int, *, timeout_s: float = 5.0):
        self.transport = transport
        self.rank = rank
        self.timeout_s = timeout_s

    def gather_window(self, local_window: np.ndarray) -> GatherResult:
        """local_window: [N, S] this rank's stage matrix for the window."""
        t0 = time.perf_counter()
        try:
            parts = self.transport.allgather(
                self.rank, np.asarray(local_window, np.float64), self.timeout_s
            )
        except Exception as e:  # transport bug: fail safe, keep training
            return GatherResult(
                ok=False,
                window=None,
                present_ranks=(self.rank,),
                elapsed_s=time.perf_counter() - t0,
                error=f"transport: {e}",
            )
        elapsed = time.perf_counter() - t0
        present = tuple(r for r, p in enumerate(parts) if p is not None)
        if len(present) != len(parts):
            return GatherResult(
                ok=False,
                window=None,
                present_ranks=present,
                elapsed_s=elapsed,
                error=f"missing ranks {sorted(set(range(len(parts))) - set(present))}",
                parts=tuple(parts),
            )
        window = np.stack(parts, axis=1)  # [N, R, S]
        return GatherResult(
            ok=True,
            window=window,
            present_ranks=present,
            elapsed_s=elapsed,
            parts=tuple(parts),
        )
