"""Batched cross-job co-activation by host: one CUDA kernel per call.

The incident tier's common-cause question — *which hosts carry a fault
that shows up in more than one job?* — reduces to integer statistics of
per-job host-level activity series.  For a fleet activity tensor
``act[J, N, H, S]`` (job j has an above-threshold candidate on host h in
stage s at step t — the thresholded exposed-increment streams of
`core.regimes`, collapsed over each host's ranks), the per-(stage, host)
evidence is:

  ``jobs[s, h]``    distinct jobs with ANY activation in the window —
                    the promotion predicate (>= 2 jobs = common-cause
                    candidate);
  ``coact[s, h]``   steps where >= 2 jobs are active simultaneously —
                    separates a genuinely shared live fault from two
                    jobs that happened to blip in disjoint step ranges;
  ``active[s, h]``  total active job-steps (the exposure mass).

`co_activation` runs the hand-written kernel `csrc/coactivation.cu` on a
CUDA tensor (see the source note for its design and bound) and its plain
torch version `_co_activation_plain` on a CPU tensor; it never falls back
from one to the other.  All statistics are integer counts, so both routes
equal the NumPy oracle `co_activation_ref` exactly.

Fabric tiers ride the same launch: `tiered_co_activation` OR-collapses
the host axis onto each declared tier's node axis (switch, pod — see
`incidents.Topology`), concatenates host + node columns into ONE
combined axis, and scores it with one call of `co_activation`: the tiers
share the folded activity series, only the aggregation axis changes, and
each tier's slice equals `co_activation_ref` on that tier's collapsed
series (`tiered_co_activation_ref`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _lib
from .ops import CSRC, NVCC_FLAGS, CoActivationPacket

__all__ = [
    "CoActivationPacket",
    "TierAxes",
    "co_activation",
    "co_activation_loop",
    "co_activation_ref",
    "tiered_co_activation",
    "tiered_co_activation_ref",
]

_SOURCE = "coactivation.cu"

#: launches of the co-activation kernel: `_co_activation_cuda` adds one
#: per launch and nothing else touches it (callers reset it to 0 to count
#: a run)
launches = 0


# ---------------------------------------------------------------------------
# the NumPy oracles
# ---------------------------------------------------------------------------


def co_activation_ref(act: np.ndarray) -> CoActivationPacket:
    """NumPy oracle of the kernel route on ``act[J, N, H, S]`` (bool).

    This is the ONE definition of the statistics — both routes must
    match it exactly (integer counts, no float accumulation anywhere).
    The packet holds NumPy arrays.
    """
    a = np.asarray(act).astype(bool)
    if a.ndim != 4:
        raise ValueError(f"expected act [J,N,H,S], got {a.shape}")
    stepsum = a.sum(axis=0, dtype=np.int64)          # [N, H, S]
    jobs = a.any(axis=1).sum(axis=0, dtype=np.int64)  # [H, S]
    coact = (stepsum >= 2).sum(axis=0, dtype=np.int64)
    active = stepsum.sum(axis=0, dtype=np.int64)
    return CoActivationPacket(
        jobs=jobs.T.astype(np.int32),
        coact=coact.T.astype(np.int32),
        active=active.T.astype(np.int32),
    )


class TierAxes(NamedTuple):
    """One fabric tier's aggregation axis over the folded host series.

    `grouping[h]` maps host column h onto this tier's node column
    (values in [0, n_nodes); -1 = the host has no node at this tier and
    contributes nowhere).  The activity series itself is SHARED across
    tiers — only this aggregation axis changes.
    """

    tier: str                 # "switch" | "pod" (host tier is implicit)
    n_nodes: int
    grouping: tuple[int, ...]  # per host column, len == H


def tiered_co_activation_ref(
    act: np.ndarray, tiers: Sequence[TierAxes]
) -> tuple[CoActivationPacket, ...]:
    """NumPy oracle of the tiered route: per tier, collapse the SAME
    host-folded series onto that tier's node axis and score it with
    `co_activation_ref` — packet 0 is the host tier itself, packet i+1
    tier ``tiers[i]``.  The tiered route must match EXACTLY per tier."""
    a = np.asarray(act).astype(bool)
    if a.ndim != 4:
        raise ValueError(f"expected act [J,N,H,S], got {a.shape}")
    out = [co_activation_ref(a)]
    for axes in tiers:
        if len(axes.grouping) != a.shape[2]:
            raise ValueError(
                f"tier {axes.tier!r} grouping covers "
                f"{len(axes.grouping)} hosts, series has {a.shape[2]}"
            )
        coll = np.zeros(
            (a.shape[0], a.shape[1], axes.n_nodes, a.shape[3]), bool
        )
        for h, g in enumerate(axes.grouping):
            if g >= 0:
                coll[:, :, g, :] |= a[:, :, h, :]
        out.append(co_activation_ref(coll))
    return tuple(out)


# ---------------------------------------------------------------------------
# the kernel wrapper and its plain version
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of `csrc/coactivation.cu`."""
    # act, then the outputs jobs, coact and active; J, N, C, S; the stream
    lib.coact_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    lib.coact_launch.restype = ctypes.c_int
    lib.coact_error_string.argtypes = [ctypes.c_int]
    lib.coact_error_string.restype = ctypes.c_char_p


def _co_activation_cuda(act: torch.Tensor) -> CoActivationPacket:
    """Launch `csrc/coactivation.cu` on ``act[J, N, H, S]`` (uint8 0/1,
    contiguous, on one CUDA device)."""
    dev = act.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA co-activation kernel needs CUDA tensors, got {dev}")
    if act.dtype != torch.uint8 or act.dim() != 4 or not act.is_contiguous():
        raise ValueError(
            "act must be a contiguous uint8 [J, N, H, S], got "
            f"{act.dtype} {tuple(act.shape)}"
        )
    jn, n, h, s = act.shape
    zeros = dict(dtype=torch.int32, device=dev)
    if min(act.shape) == 0:
        z = torch.zeros((s, h), **zeros)
        return CoActivationPacket(z, z.clone(), z.clone())
    lib = _lib.load_library(_SOURCE, _bind, CSRC, NVCC_FLAGS)
    # the kernel writes every entry once: no scratch, nothing zeroed
    jobs, coact, active = (torch.empty((s, h), **zeros) for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coact_launch(
            act.data_ptr(), jobs.data_ptr(), coact.data_ptr(),
            active.data_ptr(), jn, n, h, s, ctypes.c_void_p(stream),
        )
    if rc != 0:
        msg = lib.coact_error_string(rc).decode()
        raise RuntimeError(f"co-activation kernel launch failed: {msg} ({rc})")
    _lib.count_launch(globals(), "launches")
    return CoActivationPacket(jobs, coact, active)


def _co_activation_plain(act: torch.Tensor) -> CoActivationPacket:
    """The kernel's function in plain torch (exact integer counts)."""
    a = act != 0                                            # [J, N, H, S]
    stepsum = a.sum(dim=0, dtype=torch.int32)               # [N, H, S]
    return CoActivationPacket(
        jobs=a.any(dim=1).sum(dim=0, dtype=torch.int32).T.contiguous(),
        coact=(stepsum >= 2).sum(dim=0, dtype=torch.int32).T.contiguous(),
        active=stepsum.sum(dim=0, dtype=torch.int32).T.contiguous(),
    )


def _activity(act, device) -> torch.Tensor:
    """``act`` as a contiguous uint8 0/1 tensor on `device` (None keeps a
    tensor where it lies and puts an array on CUDA)."""
    if device is None:
        device = act.device if isinstance(act, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "co_activation: CUDA was asked for but is not available "
            "(pass device='cpu' to run the plain version on the CPU)"
        )
    if isinstance(act, np.ndarray):
        act = torch.from_numpy(np.ascontiguousarray(act))
    a = torch.as_tensor(act)
    if a.dim() != 4:
        raise ValueError(f"expected act [J,N,H,S], got {tuple(a.shape)}")
    a = a.to(device)
    if a.dtype != torch.bool:
        a = a != 0
    return a.contiguous().view(torch.uint8)   # one byte per element


def _score(a: torch.Tensor) -> CoActivationPacket:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if a.device.type == "cuda":
        return _co_activation_cuda(a)
    if a.device.type == "cpu":
        return _co_activation_plain(a)
    raise ValueError(f"unsupported device {a.device}")


def co_activation(act, *, device=None) -> CoActivationPacket:
    """Co-activation statistics of a fleet activity tensor
    ``act[J, N, H, S]`` (bool / 0-1, tensor or array): one launch folds
    every job.

    `device` None keeps a tensor's device and puts an array on CUDA.  On
    CUDA the hand-written kernel runs (or the call raises); on the CPU its
    plain torch version does.  Returns [S, H] int32 tensors on that
    device, equal to `co_activation_ref` exactly.
    """
    return _score(_activity(act, device))


def _collapse_tier(a: torch.Tensor, axes: TierAxes) -> torch.Tensor:
    """OR-collapse ``act[J, N, H, S]`` (uint8 0/1) host columns onto one
    tier's node columns -> ``[J, N, n_nodes, S]`` uint8 (any member host
    active => the node is active).  An integer sum then `> 0` is the OR,
    exact in any order."""
    group = torch.as_tensor(axes.grouping, dtype=torch.long, device=a.device)
    # unmapped hosts (-1) route to a scratch node that is sliced away
    seg = torch.where(group < 0, axes.n_nodes, group)
    j, n, h, s = a.shape
    out = torch.zeros((j, n, axes.n_nodes + 1, s), dtype=torch.int32,
                      device=a.device)
    out.index_add_(2, seg, a.to(torch.int32))
    return (out[:, :, : axes.n_nodes, :] > 0).view(torch.uint8)


def tiered_co_activation(
    act, tiers: Sequence[TierAxes], *, device=None
) -> tuple[CoActivationPacket, ...]:
    """Score the host tier AND every fabric tier in ONE launch.

    The tiers share the folded activity series ``act[J, N, H, S]`` —
    only the aggregation axis changes — so the torch prolog OR-collapses
    the host axis onto each tier's node axis (`TierAxes.grouping`,
    exact), concatenates host + node columns into one combined axis of
    size ``H + sum(n_nodes)``, and runs `co_activation` once over it.
    The outputs split back per tier: packet 0 is the host tier, packet
    i+1 tier ``tiers[i]`` — each EXACTLY equal to `co_activation_ref` on
    that tier's collapsed series (`tiered_co_activation_ref`).

    With no fabric tiers declared this is exactly `co_activation`.
    """
    a = _activity(act, device)
    h = a.shape[2]
    segments = [a]
    for axes in tiers:
        if len(axes.grouping) != h:
            raise ValueError(
                f"tier {axes.tier!r} grouping covers "
                f"{len(axes.grouping)} hosts, series has {h}"
            )
        segments.append(_collapse_tier(a, axes))
    combined = torch.cat(segments, dim=2) if len(segments) > 1 else a
    packet = _score(combined)
    out = []
    lo = 0
    for seg in segments:
        hi = lo + seg.shape[2]
        out.append(CoActivationPacket(*(t[:, lo:hi] for t in packet)))
        lo = hi
    return tuple(out)


def co_activation_loop(act, *, device=None) -> CoActivationPacket:
    """Naive per-job loop — the baseline the batched route is held
    against: one launch per job, the per-step cross-job sums folded in
    torch (each job's own sums are its activity); identical statistics,
    J launches."""
    a = _activity(act, device)
    jobs = None
    stepsum = None
    for j in range(a.shape[0]):
        one = a[j:j + 1]
        pkt = _score(one)
        jobs = pkt.jobs if jobs is None else jobs + pkt.jobs
        step = one[0].to(torch.int32)                       # [N, H, S]
        stepsum = step if stepsum is None else stepsum + step
    if jobs is None:
        z = torch.zeros(a.shape[3], a.shape[2], dtype=torch.int32,
                        device=a.device)
        return CoActivationPacket(z, z.clone(), z.clone())
    return CoActivationPacket(
        jobs=jobs,
        coact=(stepsum >= 2).sum(dim=0, dtype=torch.int32).T.contiguous(),
        active=stepsum.sum(dim=0, dtype=torch.int32).T.contiguous(),
    )
