"""Counterfactual what-if matrix engine (per-(stage, rank) interventions).

The frontier tells the operator *where* group-visible delay first appears;
the direct-exposure score `G_s` (core.gain, Eq. 4) tells them what clipping
one whole stage would be worth.  Neither answers the operator's actual
question — "if I fix THIS rank's THIS stage, how much step time comes
back?"  This module answers it for every candidate at once.

For a window d[N, R, S] and a baseline b[N, R, S], the candidate
intervention (s, r) substitutes the clipped baseline on that single
(stage, rank) cell:

    d'[t, r, s]  = min(d[t, r, s], b[t, r, s])        (never exceeds obs.)
    d'[t, r', s'] = d[t, r', s']                       everywhere else

and recomputes the step makespan.  The *recoverable time* is

    W[s, r] = sum_t ( M[t] - M^{(s,r)<-b}[t] )  >= 0   (seconds).

The sync-wait model
-------------------
In synchronized training the observed duration of a barrier-bearing stage
*contains* the wait a straggler displaced onto its peers, so a plain
substitute-and-recompute on raw durations cannot recover displaced time —
the wait is baked into every other rank's row.  When the caller declares
which stages end with a group synchronization (``sync_mask``), the engine
replays the sync semantics instead:

  1. **work imputation** — at a sync stage the observed span is
     work + wait; the per-step cross-rank minimum is the only wait-free
     observation, so ``w[t, r, sync] = min_r' d[t, r', sync]`` (non-sync
     stages are host-visible work already: ``w = d``);
  2. **counterfactual replay** — clipping candidate (s, r) lowers rank
     r's *arrival* at the first sync boundary at/after s by
     ``excess[t, r, s] = max(0, w - b)``; the release there is the max
     arrival, and every rank downstream shifts uniformly, so per step

         M - M' = max(0, A_max - max(other_max, A_r - excess)),

     where A are the replayed arrivals at the governing boundary and
     ``other_max`` comes from their top-2 (exactly the final-prefix shift
     identity of the unsynchronized case, applied at each boundary).

With ``sync_mask=None`` (or all-False) no imputation happens, the
governing boundary of every stage is the end of the window, and the
engine reduces bit-for-bit to the direct substitution on final prefixes —
the form the Pallas kernel route and `core.gain` mirror.  The whole dense
[S, R] matrix costs one pass over the window — O(N*R*S), the same as a
single frontier accounting — instead of S*R replays.

Feasibility.  W[s, r] is a *lower bound* on what a real fix recovers only
when the counterfactual is attributable: mirroring `core.gain`, when the
stage's reduction also removes the downstream wait it induces (which the
replay models only at *declared* boundaries).  The engine reuses the
labeler's ambiguity gates (`LabelerGates`) to mark — never guess — the
cases where it is a sensitivity score instead:

  * ``co_critical_tie``   — the stage sits in the share/gain near-tie set
    E_amb (eta_a / eta_g): several stages trade the frontier, so the
    counterfactual's attribution is ambiguous;
  * ``sync_wait_model_dependent`` — the stage dominates the share but its
    all-rank clipped gain is below gamma_g: the exposed time is sync wait
    whose removability depends on the wait model (W_s = 0 safe default);
  * ``sync_stage_ambiguous`` — the candidate sits *inside* a declared
    sync stage: a host delay there and a slow collective produce the same
    coarse durations on every rank (the release shifts for the whole
    group), so no single-rank attribution is possible from stage spans —
    the imputation deliberately reports ~0 instead of guessing a rank;
  * ``single_rank``       — R == 1: no cross-rank evidence, the "frontier"
    is the rank's own prefix;
  * ``below_floor``       — the window denominator is under the floor, so
    fractions (and rankings built on them) are unreliable;
  * ``group_wide``        — the candidate's own recoverable time is ~0
    while the whole-stage clip recovers materially more: the delay is
    group-wide (e.g. a slow collective), not one rank's to fix.

Interventions carrying any flag have ``feasible=False``: their W value is
reported as a sensitivity score, not an intervention estimate.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .frontier import _check
from .gain import all_stage_gains, cohort_median_baseline
from .labeler import LabelerGates, _topset

__all__ = [
    "Intervention",
    "WhatIfResult",
    "imputed_work",
    "make_sync_mask",
    "step_contributions",
    "sync_segments",
    "whatif_matrix",
    "whatif_matrix_naive",
    "top_interventions",
]

#: feasibility flag names (see module docstring)
CO_CRITICAL_TIE = "co_critical_tie"
SYNC_WAIT_MODEL_DEPENDENT = "sync_wait_model_dependent"
SYNC_STAGE_AMBIGUOUS = "sync_stage_ambiguous"
SINGLE_RANK = "single_rank"
BELOW_FLOOR = "below_floor"
GROUP_WIDE = "group_wide"

#: a candidate whose own recovery is below this fraction of the whole-stage
#: clip is group-wide: no single rank's fix explains the stage's exposure.
_GROUP_WIDE_RATIO = 0.5


@dataclasses.dataclass(frozen=True)
class Intervention:
    """One ranked counterfactual: fix (stage, rank), recover `recoverable_s`."""

    stage: int                    # ordered stage index s
    rank: int                     # rank index r
    recoverable_s: float          # W[s, r] seconds (>= 0)
    fraction: float               # W[s, r] / sum_t F[t, S] (0 when below floor)
    feasible: bool                # True iff flags is empty
    flags: tuple[str, ...]        # ambiguity-gate flags (see module docstring)


@dataclasses.dataclass(frozen=True)
class WhatIfResult:
    """Dense counterfactual answer for one window."""

    matrix: np.ndarray            # W [S, R] recoverable seconds, >= 0
    stage_recoverable: np.ndarray # [S] seconds for the ALL-rank clip of s
    stage_gains: np.ndarray       # [S] Eq. 4 G_s — bit-for-bit core.gain
    shares: np.ndarray            # [S] window shares A_s (Eq. 2), observed d
    exposed_total: float          # sum_t F[t, S] (the denominator, seconds)
    ambiguous_stages: tuple[int, ...]  # E_amb = near-tie set over shares|gains
    #: declared sync-stage indices the replay modelled ( () = none declared)
    sync_stages: tuple[int, ...] = ()

    @property
    def num_stages(self) -> int:
        return self.matrix.shape[0]

    @property
    def num_ranks(self) -> int:
        return self.matrix.shape[1]

    def fraction_matrix(self) -> np.ndarray:
        """W / sum_t F[t,S] — the matrix in step-time fractions. [S, R]"""
        if self.exposed_total <= 0.0:
            return np.zeros_like(self.matrix)
        return self.matrix / self.exposed_total

    def top(self, k: int = 5, *, gates: LabelerGates | None = None
            ) -> list[Intervention]:
        """Top-k interventions by recoverable seconds, feasibility-flagged.

        Ordering is deterministic: recoverable seconds descending, then
        (stage, rank) ascending on exact ties.
        """
        return top_interventions(self, k, gates=gates)


def make_sync_mask(
    stages: Sequence[str], sync_stages: Sequence[str]
) -> np.ndarray:
    """Boolean [S] mask from a stage list + declared sync-stage names.

    Unknown names are ignored (a packet may declare a profile whose stage
    never made it into this window's schema)."""
    names = set(sync_stages)
    return np.array([s in names for s in stages], dtype=bool)


def _as_sync_mask(sync_mask, s: int) -> np.ndarray | None:
    if sync_mask is None:
        return None
    m = np.asarray(sync_mask, dtype=bool)
    if m.shape != (s,):
        raise ValueError(f"sync_mask must be [S]=({s},), got {m.shape}")
    return m if m.any() else None


def imputed_work(durations: np.ndarray, sync_mask) -> np.ndarray:
    """Estimated wait-free work matrix w[N, R, S].

    Non-sync stages are host-visible work already (w = d).  A sync stage's
    observed span is work + wait-for-release; the per-step cross-rank
    minimum is the least-waiting observation (the straggler's own span),
    so every rank gets ``min_r d[t, r, sync]`` — idempotent, and exactly
    the always-on estimate a coarse stage vector supports.  A host delay
    *inside* a sync stage is erased by this (indistinguishable from a slow
    collective, see ``sync_stage_ambiguous``); a delay before the barrier
    is preserved, which is what the replay recovers.
    """
    d = _check(durations)
    m = _as_sync_mask(sync_mask, d.shape[2])
    if m is None:
        return d
    w = d.copy()
    for s in np.flatnonzero(m):
        w[:, :, s] = d[:, :, s].min(axis=1, keepdims=True)
    return w


def sync_segments(
    sync_stages, s: int, s_pad: int | None = None
) -> tuple[tuple[int, int], ...]:
    """Split the stage rows [0, s_pad) into sync segments.

    Each segment ends at a declared barrier stage; a trailing segment
    (whose boundary is the window end) absorbs any unsynchronized tail
    plus padded stage rows.  This is the ONE definition of the segment
    boundaries — the NumPy engine, the Pallas wrapper/kernel unroll, and
    the jnp oracle (`kernels.frontier.ref`) all import it, so they cannot
    drift apart.  ``sync_stages`` is an iterable of stage indices (empty /
    None -> one segment: the final-prefix identity).
    """
    s_pad = s if s_pad is None else s_pad
    syncs = tuple(
        sorted(set(int(i) for i in (sync_stages if sync_stages is not None else ())))
    )
    if any(i < 0 or i >= s for i in syncs):
        raise ValueError(f"sync stage index out of range for S={s}: {syncs}")
    out, start = [], 0
    for i in syncs:
        out.append((start, i))
        start = i + 1
    if start < s_pad:
        out.append((start, s_pad - 1))
    return tuple(out)


def _segments(m: np.ndarray | None, s: int) -> tuple[tuple[int, int], ...]:
    """`sync_segments` on a boolean mask (None -> no declared barriers)."""
    return sync_segments(
        None if m is None else np.flatnonzero(m).tolist(), s
    )


def step_contributions(
    durations: np.ndarray,
    baseline: np.ndarray,
    sync_mask=None,
    *,
    work: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-step recoverable-time contributions and exposed makespans.

    Returns (contrib [N, S, R], exposed [N]) with
    ``contrib[t, s, r] = M[t] - M^{(s,r)<-b}[t] >= 0`` under the declared
    sync model — every reduction is per-step independent, so this is the
    shared primitive of the batch engine and `StreamingWhatIf` (their
    equality is by construction, not by parallel implementations).
    `exposed` is the *observed* per-step makespan max_r sum_s d — the
    fraction denominator, independent of the wait model.  `work` lets a
    caller that already ran `imputed_work(d, sync_mask)` (as
    `whatif_matrix` does for its default baseline) pass it in instead of
    imputing twice.
    """
    d = _check(durations)
    n, r, s = d.shape
    m = _as_sync_mask(sync_mask, s)
    w = imputed_work(d, m) if work is None else np.asarray(work, np.float64)
    b = np.asarray(baseline, dtype=np.float64)
    if b.shape != w.shape:
        b = np.broadcast_to(b, w.shape)
    excess = np.maximum(0.0, w - b)                   # [N, R, S]
    prefix = np.cumsum(w, axis=2)                     # [N, R, S]
    exposed = d.sum(axis=2).max(axis=1)               # observed makespans

    contrib = np.empty((n, r, s))
    relbase = np.zeros(n)                             # release of prev sync
    for start, end in _segments(m, s):
        # replayed arrivals at this segment's boundary (the governing sync,
        # or the window end for the trailing segment).
        seg = prefix[:, :, end] - (
            prefix[:, :, start - 1] if start else 0.0
        )
        arr = relbase[:, None] + seg                  # [N, R]
        amax = arr.max(axis=1)                        # [N]
        lead = arr.argmax(axis=1)                     # [N] lowest on ties
        if r >= 2:
            second = np.partition(arr, r - 2, axis=1)[:, r - 2]
        else:
            second = np.full(n, -np.inf)
        # max over the OTHER ranks' arrivals: the leader sees the second
        # max, everyone else the max (duplicate maxima keep second = max).
        other = np.where(
            np.arange(r)[None, :] == lead[:, None],
            second[:, None],
            amax[:, None],
        )                                             # [N, R]
        e = excess[:, :, start : end + 1]             # [N, R, seg]
        new_a = np.maximum(other[:, :, None], arr[:, :, None] - e)
        contrib[:, :, start : end + 1] = np.maximum(
            0.0, amax[:, None, None] - new_a
        )
        if m is not None and m[end]:
            relbase = amax
    # single-rank windows: other = -inf, new_a = arr - excess exactly.
    return np.transpose(contrib, (0, 2, 1)), exposed  # [N, S, R], [N]


def _stage_recoverable(
    w: np.ndarray, excess: np.ndarray, m: np.ndarray | None
) -> np.ndarray:
    """All-rank clip of each stage under the same replay: [S] seconds.

    Clipping stage s on EVERY rank lowers each arrival at the governing
    boundary by its own excess; the release drop is
    ``amax - max_r (arr_r - excess_r)`` and everything downstream shifts
    uniformly.  The no-sync specialization is exactly the Eq. 4 numerator
    (`core.gain.direct_exposure_gain` before the denominator).
    """
    n, r, s = w.shape
    prefix = np.cumsum(w, axis=2)
    out = np.empty(s)
    relbase = np.zeros(n)
    for start, end in _segments(m, s):
        seg = prefix[:, :, end] - (
            prefix[:, :, start - 1] if start else 0.0
        )
        arr = relbase[:, None] + seg                  # [N, R]
        amax = arr.max(axis=1)
        e = excess[:, :, start : end + 1]             # [N, R, seg]
        new_rel = (arr[:, :, None] - e).max(axis=1)   # [N, seg]
        out[start : end + 1] = (amax[:, None] - new_rel).sum(axis=0)
        relbase = amax
    return out


def whatif_matrix(
    durations: np.ndarray,
    baseline: np.ndarray | None = None,
    *,
    sync_mask=None,
    gates: LabelerGates | None = None,
) -> WhatIfResult:
    """Dense [S, R] counterfactual recoverable-time matrix for one window.

    `sync_mask` ([S] bool, or None) declares which stages end with a group
    synchronization — see the module docstring's sync-wait model; without
    it the engine is the pure final-prefix substitution.  `baseline`
    defaults to the cohort (cross-rank) median *of the imputed work* — the
    hidden-rank-exposing default shared with the labeler; `stage_gains` is
    computed through `core.gain.all_stage_gains` on the same work matrix
    and baseline, so it is bit-for-bit the Eq. 4 score (property-tested).
    """
    g = gates or LabelerGates()
    d = _check(durations)
    n, r, s = d.shape
    m = _as_sync_mask(sync_mask, s)
    w = imputed_work(d, m)
    if baseline is None:
        baseline = cohort_median_baseline(w)
    contrib, exposed = step_contributions(d, baseline, m, work=w)
    matrix = contrib.sum(axis=0)                      # [S, R]
    exposed_total = float(exposed.sum())

    # Whole-stage (all ranks clipped) recovery under the same replay, and
    # Eq. 4 gains — delegated to core.gain so the fraction is bit-identical
    # to the labeler's score on the same (work, baseline) pair.
    b = np.asarray(baseline, dtype=np.float64)
    if b.shape != w.shape:
        b = np.broadcast_to(b, w.shape)
    stage_recoverable = _stage_recoverable(w, np.maximum(0.0, w - b), m)
    gains = all_stage_gains(w, b)                     # [S] fractions

    # Window shares of the OBSERVED durations for the ambiguity tie set
    # (labeler's E_amb gates — attribution is about what was seen).
    prefix = np.cumsum(d, axis=2)
    frontier = prefix.max(axis=1)                     # [N, S]
    advances = np.diff(frontier, axis=1, prepend=0.0)
    shares = (
        advances.sum(axis=0) / exposed_total
        if exposed_total > 0.0
        else np.zeros(s)
    )
    e_amb = sorted(_topset(shares, g.eta_a) | _topset(gains, g.eta_g))
    return WhatIfResult(
        matrix=matrix,
        stage_recoverable=stage_recoverable,
        stage_gains=gains,
        shares=shares,
        exposed_total=exposed_total,
        ambiguous_stages=tuple(e_amb),
        sync_stages=tuple(int(i) for i in np.flatnonzero(m))
        if m is not None
        else (),
    )


def _replay_makespan(w: np.ndarray, m: np.ndarray | None) -> np.ndarray:
    """Discrete-event replay oracle: per-step makespan [N] of work w."""
    n, r, s = w.shape
    out = np.empty(n)
    for t in range(n):
        clock = np.zeros(r)
        for si in range(s):
            clock = clock + w[t, :, si]
            if m is not None and m[si]:
                clock = np.full(r, clock.max())
        out[t] = clock.max()
    return out


def whatif_matrix_naive(
    durations: np.ndarray,
    baseline: np.ndarray | None = None,
    sync_mask=None,
) -> np.ndarray:
    """S*R-replay reference: clip one (stage, rank) cell of the imputed
    work, re-run the full sync replay, subtract.  O(N*R^2*S^2) — exists to
    validate (and benchmark) the one-pass closed form, never to serve."""
    d = _check(durations)
    n, r, s = d.shape
    m = _as_sync_mask(sync_mask, s)
    w = imputed_work(d, m)
    if baseline is None:
        baseline = cohort_median_baseline(w)
    b = np.broadcast_to(np.asarray(baseline, dtype=np.float64), w.shape)
    base = _replay_makespan(w, m)
    out = np.zeros((s, r))
    for si in range(s):
        for ri in range(r):
            repl = w.copy()
            repl[:, ri, si] = np.minimum(w[:, ri, si], b[:, ri, si])
            out[si, ri] = (base - _replay_makespan(repl, m)).sum()
    return out


def top_interventions(
    result: WhatIfResult,
    k: int = 5,
    *,
    gates: LabelerGates | None = None,
) -> list[Intervention]:
    """Rank candidates by recoverable seconds with feasibility flags.

    Flags mark — never suppress — candidates whose value is a sensitivity
    score rather than an intervention lower bound (module docstring);
    callers decide whether flagged entries are actionable.  Ordering is
    deterministic: (-recoverable_s, stage, rank).
    """
    g = gates or LabelerGates()
    w = result.matrix
    s_count, r_count = w.shape
    below_floor = result.exposed_total < g.denominator_floor
    near_tie = len(result.ambiguous_stages) > 1
    sync_set = set(result.sync_stages)

    order = np.argsort(-w, axis=None, kind="stable")
    out: list[Intervention] = []
    for flat in order[: max(0, k)]:
        si, ri = divmod(int(flat), r_count)
        rec = float(w[si, ri])
        flags: list[str] = []
        if near_tie and si in result.ambiguous_stages:
            flags.append(CO_CRITICAL_TIE)
        if (
            float(result.shares[si]) > g.gamma_a
            and float(result.stage_gains[si]) < g.gamma_g
        ):
            flags.append(SYNC_WAIT_MODEL_DEPENDENT)
        if si in sync_set:
            flags.append(SYNC_STAGE_AMBIGUOUS)
        if r_count < 2:
            flags.append(SINGLE_RANK)
        if below_floor:
            flags.append(BELOW_FLOOR)
        stage_rec = float(result.stage_recoverable[si])
        if stage_rec > 0.0 and rec < _GROUP_WIDE_RATIO * stage_rec:
            flags.append(GROUP_WIDE)
        out.append(
            Intervention(
                stage=si,
                rank=ri,
                recoverable_s=rec,
                fraction=(
                    rec / result.exposed_total if not below_floor else 0.0
                ),
                feasible=not flags,
                flags=tuple(flags),
            )
        )
    return out
