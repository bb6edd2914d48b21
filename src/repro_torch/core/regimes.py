"""Temporal regime engine: is the fault still happening?

The frontier tells an operator *where* group-visible delay first appears
and the what-if engine prices *what a fix would recover* — but neither
says whether the fault is still live.  Production stragglers are a mix of
transient blips (self-healing, not worth a profiler), recurring
intermittents (worth catching in the act), and persistent degradations
(profile now).  This module segments each per-(stage, rank)
exposed-increment stream into stationary regimes and classifies the
activity pattern, online.

The signal
----------
For a window d[N, R, S] and a per-cell reference b[R, S] (default: the
cohort median, the same hidden-rank-exposing reference the labeler and
what-if engine use), the **exposed-increment stream** of candidate (s, r)
is the per-step excess over the reference:

    e[t, r, s] = max(0, w[t, r, s] - b[r, s])

where w is the sync-imputed work (`core.whatif.imputed_work` — barrier
stages get the per-step cross-rank minimum, so group wait does not read
as every rank's own excess).  The stream is *thresholded* into an
activity series

    act[t, r, s] = e[t, r, s] > thresh[r, s],
    thresh[r, s] = max(min_excess_s, rel_excess * b[r, s]),

and each maximal run of constant activity is one **stationary regime**
(`segment_stream`) — change points are exactly the activity transitions,
which is the form an online engine can maintain with O(1) state per
candidate and a batched kernel can reduce exactly.

Classification
--------------
Per candidate, from the window's activity series (N steps, onset = first
active step, streak = trailing consecutive active steps, runs = number of
distinct active bursts):

  ``none``        never active in the window;
  ``persistent``  active now and either continuously since onset or for at
                  least `persistent_streak` consecutive trailing steps —
                  a step-function degradation or a slow drift that has
                  crossed the threshold and stayed there;
  ``recurring``   two or more distinct bursts (and not currently in a
                  persistent-length run): an intermittent;
  ``transient``   exactly one burst that has healed (streak == 0): a blip.

The calls are *provisional by design*: a step fault one step after onset
reads persistent (it is live and has never healed), and becomes transient
the moment it heals.  Online classification reports the best temporal
statement the evidence supports at this step, exactly like the labeler's
evidence-scoped labels.

Each candidate also carries its **onset step**, **duty cycle** (active
fraction of the steps since onset), and **trend slope** (least-squares
slope of the excess over the window, seconds/step — positive for a
drifting degradation, ~0 for a stationary one).

Persistence weight
------------------
`persistence_weight` maps the classification to a [0, 1] routing weight:

    weight = duty_since_onset * recency
    recency = 1                         if active now (streak > 0)
              max(0, 1 - gap/cooldown)  otherwise (gap = steps since the
                                        last active step)

so a persistent fault weighs ~1, an intermittent weighs its duty cycle,
and a healed blip decays to 0 over `transient_cooldown` steps.  The fleet
service multiplies routing scores by this weight (floored — see
`fleet.service`), so `route(k)` prefers faults that are both recoverable
*and* still live.

Everything here is pure NumPy; `repro.kernels.frontier` provides the
batched [J, N, R, S] Pallas route (`fleet_regime_stats`) for the same
per-candidate statistics, checked exactly against `regime_segments_ref`,
and `core.streaming.StreamingRegimes` is the incremental form
(bit-for-bit equal to this batch pass over the retained steps).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .frontier import _check
from .gain import cohort_median_baseline
from .whatif import _as_sync_mask, imputed_work

__all__ = [
    "NONE",
    "TRANSIENT",
    "RECURRING",
    "PERSISTENT",
    "REGIME_NAMES",
    "RegimeParams",
    "RegimeStats",
    "RegimeSegment",
    "RegimeCall",
    "RegimeResult",
    "excess_stream",
    "regime_stats",
    "segment_stream",
    "classify",
    "persistence_weight",
    "segment_regimes",
]

#: classification codes (array dtype int8); REGIME_NAMES maps code -> name.
NONE = 0
TRANSIENT = 1
RECURRING = 2
PERSISTENT = 3
REGIME_NAMES = ("none", "transient", "recurring", "persistent")


@dataclasses.dataclass(frozen=True)
class RegimeParams:
    """Thresholds of the regime engine (all deterministic).

    min_excess_s:      absolute activity floor (seconds) — excess below it
                       never counts as active, whatever the reference.
    rel_excess:        relative activity floor as a fraction of the
                       reference (thresh = max(min_excess_s, rel * b)).
    persistent_streak: trailing consecutive active steps that promote a
                       live fault to `persistent` even when it had gaps.
    transient_cooldown: steps over which a healed fault's persistence
                       weight decays to 0.
    """

    min_excess_s: float = 0.005
    rel_excess: float = 0.25
    persistent_streak: int = 5
    transient_cooldown: int = 10

    def threshold(self, baseline: np.ndarray) -> np.ndarray:
        """Per-cell activity threshold from a reference matrix."""
        return np.maximum(
            self.min_excess_s, self.rel_excess * np.asarray(baseline, float)
        )


@dataclasses.dataclass(frozen=True)
class RegimeStats:
    """Per-candidate temporal statistics over one window. All arrays [S, R].

    Integer stats are exact reductions of the thresholded activity series
    (what the batched kernel computes); float stats are the two sums the
    trend slope needs.  `num_steps` is the window length N.
    """

    count: np.ndarray         # active steps                        int
    onset: np.ndarray         # first active step, -1 if never      int
    last: np.ndarray          # last active step, -1 if never       int
    runs: np.ndarray          # distinct active bursts              int
    streak: np.ndarray        # trailing consecutive active steps   int
    sum_excess: np.ndarray    # sum_t e[t]            (seconds)     float
    sum_t_excess: np.ndarray  # sum_t t * e[t]    (step-seconds)    float
    num_steps: int

    @property
    def num_stages(self) -> int:
        return self.count.shape[0]

    @property
    def num_ranks(self) -> int:
        return self.count.shape[1]

    def active_now(self) -> np.ndarray:
        """[S, R] bool — is the candidate active at the window's last step."""
        return self.streak > 0

    def duty(self) -> np.ndarray:
        """Active fraction of the steps since onset (0 when never active)."""
        span = np.maximum(1, self.num_steps - self.onset)
        return np.where(self.onset >= 0, self.count / span, 0.0)

    def slope(self) -> np.ndarray:
        """Least-squares slope of the excess over the window (s/step).

        Closed form from the two retained sums:
        slope = (Σ t·e − t̄ Σ e) / Σ (t − t̄)², with Σ (t − t̄)² =
        N(N²−1)/12.  Zero for single-step windows.
        """
        n = self.num_steps
        if n < 2:
            return np.zeros_like(self.sum_excess)
        tbar = (n - 1) / 2.0
        denom = n * (n * n - 1) / 12.0
        return (self.sum_t_excess - tbar * self.sum_excess) / denom


@dataclasses.dataclass(frozen=True)
class RegimeSegment:
    """One stationary regime of a single candidate's stream."""

    start: int                # first step of the segment (inclusive)
    end: int                  # last step of the segment (inclusive)
    active: bool              # above-threshold segment?
    mean_excess: float        # mean of e[t] over the segment (seconds)

    @property
    def length(self) -> int:
        return self.end - self.start + 1


@dataclasses.dataclass(frozen=True)
class RegimeCall:
    """The classification of one candidate, with its evidence."""

    label: int                # NONE | TRANSIENT | RECURRING | PERSISTENT
    onset: int                # first active step (-1 if never)
    duty: float               # active fraction of steps since onset
    slope: float              # excess trend, seconds/step
    streak: int               # trailing consecutive active steps
    weight: float             # persistence weight in [0, 1]

    @property
    def name(self) -> str:
        return REGIME_NAMES[self.label]


@dataclasses.dataclass(frozen=True)
class RegimeResult:
    """Dense temporal answer for one window."""

    stats: RegimeStats
    labels: np.ndarray        # [S, R] int8 classification codes
    weights: np.ndarray       # [S, R] persistence weights in [0, 1]
    params: RegimeParams

    @property
    def num_steps(self) -> int:
        return self.stats.num_steps

    def call(self, stage: int, rank: int) -> RegimeCall:
        """One candidate's classification with its evidence numbers."""
        st = self.stats
        return RegimeCall(
            label=int(self.labels[stage, rank]),
            onset=int(st.onset[stage, rank]),
            duty=float(st.duty()[stage, rank]),
            slope=float(st.slope()[stage, rank]),
            streak=int(st.streak[stage, rank]),
            weight=float(self.weights[stage, rank]),
        )

    def label_name(self, stage: int, rank: int) -> str:
        return REGIME_NAMES[int(self.labels[stage, rank])]

    def counts(self) -> dict[str, int]:
        """Candidates per class, for dashboards/snapshots."""
        return {
            name: int((self.labels == code).sum())
            for code, name in enumerate(REGIME_NAMES)
        }


def excess_stream(
    durations: np.ndarray,
    baseline: np.ndarray | None = None,
    *,
    sync_mask=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-(stage, rank) exposed-increment streams of one window.

    Returns (e [N, R, S], b [R, S]): e is the per-step excess of the
    sync-imputed work over the reference, b the reference itself
    (defaulting to the cohort median of the imputed work — constant
    across steps, so the streaming engine can fix it at construction).
    Every operation is per-step independent: the streaming fold computes
    the identical rows one step at a time.
    """
    d = _check(durations)
    n, r, s = d.shape
    m = _as_sync_mask(sync_mask, s)
    w = imputed_work(d, m)
    if baseline is None:
        baseline = cohort_median_baseline(w)[0]       # [R, S] (constant in t)
    b = np.broadcast_to(np.asarray(baseline, float), (r, s))
    return np.maximum(0.0, w - b[None]), b


def regime_stats(
    excess: np.ndarray, thresh: np.ndarray
) -> RegimeStats:
    """Exact per-candidate reductions of the thresholded streams.

    excess: [N, R, S] exposed-increment streams; thresh: [R, S] activity
    thresholds.  Returns [S, R]-oriented stats (matching the what-if
    matrix orientation).  This is the one definition of the statistics —
    the streaming engine assembles its ring and calls it, and the Pallas
    route (`kernels.frontier.fleet_regime_stats`) must match it.
    """
    e = np.asarray(excess, float)
    if e.ndim != 3:
        raise ValueError(f"expected excess [N,R,S], got {e.shape}")
    n, r, s = e.shape
    th = np.broadcast_to(np.asarray(thresh, float), (r, s))
    if n == 0:
        z = np.zeros((s, r), np.int64)
        return RegimeStats(
            count=z,
            onset=z - 1,
            last=z - 1,
            runs=z.copy(),
            streak=z.copy(),
            sum_excess=np.zeros((s, r)),
            sum_t_excess=np.zeros((s, r)),
            num_steps=0,
        )
    act = e > th[None]                                # [N, R, S]
    acti = act.astype(np.int64)

    count = acti.sum(axis=0)                          # [R, S]
    any_ = count > 0
    onset = np.where(any_, act.argmax(axis=0), -1)
    last = np.where(any_, n - 1 - act[::-1].argmax(axis=0), -1)
    prev = np.concatenate([np.zeros((1, r, s), bool), act[:-1]], axis=0)
    runs = (act & ~prev).sum(axis=0)
    streak = np.cumprod(acti[::-1], axis=0).sum(axis=0)
    t_col = np.arange(n, dtype=float)[:, None, None]
    return RegimeStats(
        count=count.T,
        onset=onset.T,
        last=last.T,
        runs=runs.T,
        streak=streak.T,
        sum_excess=e.sum(axis=0).T,
        sum_t_excess=(t_col * e).sum(axis=0).T,
        num_steps=n,
    )


def segment_stream(
    excess: np.ndarray, thresh: float
) -> tuple[RegimeSegment, ...]:
    """Stationary-regime segmentation of ONE candidate's stream e[N].

    Change points are the activity transitions of the thresholded series;
    each maximal constant-activity run is one segment with its mean
    level.  This is the per-candidate view the docs walk through; the
    window statistics (`regime_stats`) are exactly the reductions of this
    segmentation.
    """
    e = np.asarray(excess, float).ravel()
    if e.size == 0:
        return ()
    act = e > float(thresh)
    bounds = np.flatnonzero(np.diff(act)) + 1
    out = []
    start = 0
    for end in (*bounds, e.size):
        out.append(
            RegimeSegment(
                start=start,
                end=end - 1,
                active=bool(act[start]),
                mean_excess=float(e[start:end].mean()),
            )
        )
        start = end
    return tuple(out)


def classify(
    stats: RegimeStats, params: RegimeParams | None = None
) -> np.ndarray:
    """[S, R] int8 classification codes from the window statistics."""
    p = params or RegimeParams()
    n = stats.num_steps
    never = stats.count == 0
    # active now, and either continuously since onset or for a
    # persistent-length trailing run
    live = stats.streak > 0
    since_onset = stats.streak >= np.maximum(1, n - stats.onset)
    persistent = live & (since_onset | (stats.streak >= p.persistent_streak))
    recurring = stats.runs >= 2
    out = np.full(stats.count.shape, TRANSIENT, np.int8)
    out[recurring] = RECURRING
    out[persistent] = PERSISTENT
    out[never] = NONE
    return out


def persistence_weight(
    stats: RegimeStats, params: RegimeParams | None = None
) -> np.ndarray:
    """[S, R] routing weight in [0, 1]: duty since onset x recency.

    A live fault keeps its full duty-cycle weight; a healed one decays
    linearly to 0 over `transient_cooldown` steps of inactivity.  Never-
    active candidates weigh 0.
    """
    p = params or RegimeParams()
    n = stats.num_steps
    gap = np.where(stats.last >= 0, n - 1 - stats.last, n)
    recency = np.where(
        stats.streak > 0,
        1.0,
        np.maximum(0.0, 1.0 - gap / max(1, p.transient_cooldown)),
    )
    return np.where(stats.onset >= 0, stats.duty() * recency, 0.0)


def segment_regimes(
    durations: np.ndarray,
    baseline: np.ndarray | None = None,
    *,
    sync_mask=None,
    params: RegimeParams | None = None,
) -> RegimeResult:
    """Full batch pass: window -> per-candidate regime classification.

    The composition of `excess_stream` -> `regime_stats` -> `classify` /
    `persistence_weight`; `StreamingRegimes` reproduces it bit-for-bit
    over its retained steps by assembling the identical excess rows and
    calling the same reductions.
    """
    p = params or RegimeParams()
    e, b = excess_stream(durations, baseline, sync_mask=sync_mask)
    stats = regime_stats(e, p.threshold(b))
    return RegimeResult(
        stats=stats,
        labels=classify(stats, p),
        weights=persistence_weight(stats, p),
        params=p,
    )
