"""Incremental (streaming) frontier engine — one step at a time.

`frontier_accounting` is the batch pass: it wants the whole window tensor
d[N, R, S] in memory at once (O(N*R*S)).  At fleet scale that is the wrong
shape: an aggregator watching thousands of jobs sees one step vector per
job per tick and must keep per-job state bounded by the *summary* size,
not the rank count.

`StreamingFrontier` folds one step matrix d[R, S] at a time into a ring
buffer of per-boundary accumulators (frontier, advance, leader, gap, lag,
exposed makespan).  Each fold is O(R*S) work but only O(window * S) state
is retained — the [R, S] matrix is dropped as soon as it is folded, which
is the difference between 0.11 MB and 15.81 GB once R reaches fleet sizes.

Equivalence contract (property-tested): for any sequence of pushed steps,
the assembled window state is **bit-for-bit identical** to running
`frontier_accounting` on the stacked tensor of the same steps — the same
NumPy reductions run in the same order, just one step at a time.  When
more than `capacity` steps have been pushed, the state matches the batch
pass over the trailing `capacity` steps (a sliding window).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .frontier import frontier_accounting, window_shares

__all__ = [
    "StreamingFrontier",
    "StreamingRegimes",
    "StreamingWindowState",
    "StreamingWhatIf",
    "WindowStager",
]


class _Ring:
    """Sliding-window cursor shared by the streaming engines.

    Tracks the filled slot count, the write position, and lifetime pushes
    over `capacity` ring slots — one copy of the eviction/ordering logic,
    so `StreamingFrontier` and `StreamingWhatIf` cannot drift apart.
    """

    __slots__ = ("capacity", "count", "next", "seen")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.count = 0           # filled slots (<= capacity)
        self.next = 0            # ring write cursor
        self.seen = 0            # lifetime pushes

    def advance(self, n: int = 1) -> int:
        """Claim `n` consecutive slots; returns the first slot index."""
        i = self.next
        self.next = (self.next + n) % self.capacity
        self.count = min(self.count + n, self.capacity)
        self.seen += n
        return i

    def reset(self) -> None:
        self.count = 0
        self.next = 0
        self.seen = 0

    def order(self) -> np.ndarray:
        """Ring slot indices in chronological order."""
        if self.count < self.capacity:
            return np.arange(self.count)
        return np.concatenate(
            [np.arange(self.next, self.capacity), np.arange(self.next)]
        )


@dataclasses.dataclass(frozen=True)
class StreamingWindowState:
    """Assembled window accounting, chronologically ordered.

    Field-for-field comparable with `FrontierResult` (minus the per-rank
    prefix tensor, which a streaming consumer deliberately does not keep).
    """

    frontier: np.ndarray          # F   [N, S]
    advances: np.ndarray          # a   [N, S]
    exposed_makespan: np.ndarray  # F[:, -1]  [N]
    leader: np.ndarray            # [N, S] int
    gap: np.ndarray               # [N, S]  max - secondmax (+inf when R == 1)
    lag: np.ndarray               # [N, S]  max - median
    steps_seen: int               # total pushes, including evicted steps

    @property
    def num_steps(self) -> int:
        return self.frontier.shape[0]

    @property
    def num_stages(self) -> int:
        return self.frontier.shape[1]

    def shares(self) -> np.ndarray:
        """Step-time-weighted window stage shares A_s (Eq. 2). [S]"""
        return window_shares(self.advances, self.exposed_makespan)


class StreamingFrontier:
    """Ring-buffer frontier accounting over a sliding window of steps.

    Args:
      world_size: expected rank count R of each pushed step matrix.
      num_stages: expected ordered stage count S.
      capacity:   window length; pushing beyond it evicts the oldest step.
    """

    def __init__(self, world_size: int, num_stages: int, *, capacity: int = 100):
        if world_size < 1 or num_stages < 1:
            raise ValueError("world_size and num_stages must be >= 1")
        self.world_size = world_size
        self.num_stages = num_stages
        self._ring = _Ring(capacity)
        c, s = capacity, num_stages
        self._frontier = np.zeros((c, s))
        self._advances = np.zeros((c, s))
        self._leader = np.zeros((c, s), dtype=np.intp)
        self._gap = np.zeros((c, s))
        self._lag = np.zeros((c, s))

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    # -- feeding -----------------------------------------------------------

    def push(self, durations: np.ndarray) -> int:
        """Fold one step matrix d[R, S]; returns the lifetime step index."""
        d = np.asarray(durations, dtype=np.float64)
        if d.shape != (self.world_size, self.num_stages):
            raise ValueError(
                f"expected [R,S]=({self.world_size},{self.num_stages}), "
                f"got {d.shape}"
            )
        # Delegate the per-step math to the batch pass on a 1-step window:
        # equivalence with `frontier_accounting` is true by construction,
        # not by keeping two copies of the reductions in sync.  Only the
        # [S]-sized boundary summaries are retained.
        res = frontier_accounting(d)
        i = self._ring.advance()
        self._frontier[i] = res.frontier[0]
        self._advances[i] = res.advances[0]
        self._leader[i] = res.leader[0]
        self._gap[i] = res.gap[0]
        self._lag[i] = res.lag[0]
        return self._ring.seen - 1

    fold = push  # folding one step into the accumulators IS the push

    def push_many(self, durations: np.ndarray) -> int:
        """Fold a whole [N, R, S] block in one batch pass.

        Bit-identical to N sequential `push` calls (per-step math is
        independent), but one `frontier_accounting` call instead of N —
        the ingest hot path folds arriving windows this way.
        Returns the lifetime index of the last folded step.
        """
        d = np.asarray(durations, dtype=np.float64)
        if d.ndim != 3 or d.shape[1:] != (self.world_size, self.num_stages):
            raise ValueError(
                f"expected [N,R,S]=(*,{self.world_size},{self.num_stages}), "
                f"got {d.shape}"
            )
        n = d.shape[0]
        if n == 0:
            return self._ring.seen - 1
        keep = min(n, self.capacity)
        # only the trailing `capacity` steps survive eviction; per-step math
        # is independent, so accounting just the tail is bit-identical
        res = frontier_accounting(d[n - keep:])
        idx = (self._ring.next + np.arange(n - keep, n)) % self.capacity
        self._frontier[idx] = res.frontier
        self._advances[idx] = res.advances
        self._leader[idx] = res.leader
        self._gap[idx] = res.gap
        self._lag[idx] = res.lag
        self._ring.advance(n)
        return self._ring.seen - 1

    def reset(self) -> None:
        self._ring.reset()

    # -- reading -----------------------------------------------------------

    @property
    def num_steps(self) -> int:
        """Steps currently held in the window (<= capacity)."""
        return self._ring.count

    @property
    def steps_seen(self) -> int:
        return self._ring.seen

    def state(self) -> StreamingWindowState:
        """Assemble the current window (chronological, oldest first)."""
        o = self._ring.order()
        frontier = self._frontier[o]
        return StreamingWindowState(
            frontier=frontier,
            advances=self._advances[o],
            exposed_makespan=frontier[:, -1]
            if self._ring.count
            else np.zeros(0),
            leader=self._leader[o],
            gap=self._gap[o],
            lag=self._lag[o],
            steps_seen=self._ring.seen,
        )

    def shares(self) -> np.ndarray:
        return self.state().shares()

    def exposed_total(self) -> float:
        """sum_t F[t, S] over the retained window — one O(window) gather,
        no full `state()` assembly (the fleet routing denominator)."""
        return float(self._frontier[:, -1][self._ring.order()].sum())


class StreamingWhatIf:
    """Incremental counterfactual what-if matrix over a sliding window.

    The batch engine (`core.whatif.whatif_matrix`) wants the whole
    [N, R, S] window; at fleet scale the aggregator sees one step at a
    time.  Each pushed step's per-(stage, rank) recoverable-time
    contribution ``contrib[t, s, r] = M[t] - M^{(s,r)<-b}[t]`` is
    per-step independent, so the window matrix is just the sum of the
    retained per-step contributions: a ring buffer of [S, R] summaries
    (O(window * S * R) state — the matrix itself is [S, R], so this is the
    output size times the window, and the raw [R, S] step is dropped at
    fold time).

    The baseline is fixed at construction (an explicit reference, or a
    cohort median carried over from a previous window): a window-median
    baseline cannot be known at push time, and silently re-deriving it
    per push would make early and late folds of the same step disagree.
    Call `rebase(baseline)` to swap references — it resets the window.
    `sync_mask` declares barrier-bearing stages (see `core.whatif`'s
    sync-wait model); the imputation and replay are per-step, so the
    streaming fold models them exactly like the batch pass.

    Equivalence contract (property-tested): `matrix()` is **bit-for-bit**
    equal to ``whatif_matrix(stacked, baseline, sync_mask=...).matrix``
    over the same trailing `capacity` steps — both paths run
    `step_contributions` and sum the identical per-step arrays in
    chronological order.
    """

    def __init__(
        self,
        world_size: int,
        num_stages: int,
        baseline: np.ndarray,
        *,
        capacity: int = 100,
        sync_mask=None,
    ):
        if world_size < 1 or num_stages < 1:
            raise ValueError("world_size and num_stages must be >= 1")
        self.world_size = world_size
        self.num_stages = num_stages
        self._ring = _Ring(capacity)
        self._baseline = np.broadcast_to(
            np.asarray(baseline, dtype=np.float64),
            (world_size, num_stages),
        ).copy()
        self._sync_mask = (
            None
            if sync_mask is None
            else np.asarray(sync_mask, dtype=bool).copy()
        )
        if self._sync_mask is not None and self._sync_mask.shape != (
            num_stages,
        ):
            raise ValueError(
                f"sync_mask must be [S]=({num_stages},), "
                f"got {self._sync_mask.shape}"
            )
        self._contrib = np.zeros((capacity, num_stages, world_size))
        self._exposed = np.zeros(capacity)

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    @property
    def baseline(self) -> np.ndarray:
        return self._baseline

    @property
    def num_steps(self) -> int:
        return self._ring.count

    @property
    def steps_seen(self) -> int:
        return self._ring.seen

    def push(self, durations: np.ndarray) -> int:
        """Fold one step matrix d[R, S]; returns the lifetime step index."""
        from .whatif import step_contributions

        d = np.asarray(durations, dtype=np.float64)
        if d.shape != (self.world_size, self.num_stages):
            raise ValueError(
                f"expected [R,S]=({self.world_size},{self.num_stages}), "
                f"got {d.shape}"
            )
        contrib, exposed = step_contributions(
            d[None], self._baseline[None], self._sync_mask
        )
        i = self._ring.advance()
        self._contrib[i] = contrib[0]
        self._exposed[i] = exposed[0]
        return self._ring.seen - 1

    def rebase(self, baseline: np.ndarray) -> None:
        """Swap the baseline reference; resets the window (contributions
        against the old reference are not comparable to new ones)."""
        self._baseline = np.broadcast_to(
            np.asarray(baseline, dtype=np.float64),
            (self.world_size, self.num_stages),
        ).copy()
        self.reset()

    def reset(self) -> None:
        self._ring.reset()

    def matrix(self) -> np.ndarray:
        """Window recoverable-time matrix W[S, R] (seconds, >= 0)."""
        if not self._ring.count:
            return np.zeros((self.num_stages, self.world_size))
        return self._contrib[self._ring.order()].sum(axis=0)

    def exposed_total(self) -> float:
        """sum_t F[t, S] over the window (the fraction denominator)."""
        return float(self._exposed[self._ring.order()].sum())


class StreamingRegimes:
    """Incremental temporal regime engine over a sliding window of steps.

    The batch engine (`core.regimes.segment_regimes`) wants the whole
    [N, R, S] window; the fleet aggregator sees one step matrix at a
    time, and the temporal question — is the fault still happening? —
    needs a history *longer* than one evidence packet.  Each pushed step
    is reduced to its per-candidate excess row e[R, S] (the
    exposed-increment stream's value at this step, computed against a
    reference fixed at construction) and retained in a ring buffer; the
    raw step matrix is dropped at fold time.

    The reference is fixed at construction for the same reason as
    `StreamingWhatIf`'s baseline: a window-derived reference cannot be
    known at push time, and re-deriving it per push would make early and
    late folds of the same step disagree.  `rebase(baseline)` swaps
    references and resets the window.  `sync_mask` declares
    barrier-bearing stages; the imputation is per-step (cross-rank
    minimum), so the streaming fold models it exactly like the batch
    pass.

    Equivalence contract (property-tested): `result()` is **bit-for-bit**
    equal to ``segment_regimes(stacked, baseline, sync_mask=...,
    params=...)`` over the same trailing `capacity` steps — both paths
    build the identical excess rows and run the identical reductions
    (`core.regimes.regime_stats`) over them.  Onset/last/streak indices
    are window-relative; `steps_seen` converts them to stream
    coordinates.
    """

    def __init__(
        self,
        world_size: int,
        num_stages: int,
        baseline: np.ndarray,
        *,
        capacity: int = 100,
        sync_mask=None,
        params=None,
        dtype=np.float64,
    ):
        """`dtype` sets the excess ring's storage precision.  float64
        (default) keeps the bit-for-bit equivalence with the batch pass;
        float32 halves the retained bytes (the fleet registry's choice —
        classification thresholds sit far above f32 resolution, and the
        Pallas route reduces in f32 anyway)."""
        from .regimes import RegimeParams

        if world_size < 1 or num_stages < 1:
            raise ValueError("world_size and num_stages must be >= 1")
        self.world_size = world_size
        self.num_stages = num_stages
        self.params = params or RegimeParams()
        self._ring = _Ring(capacity)
        self._baseline = np.broadcast_to(
            np.asarray(baseline, dtype=np.float64),
            (world_size, num_stages),
        ).copy()
        self._thresh = self.params.threshold(self._baseline)
        self._sync_mask = (
            None
            if sync_mask is None
            else np.asarray(sync_mask, dtype=bool).copy()
        )
        if self._sync_mask is not None and self._sync_mask.shape != (
            num_stages,
        ):
            raise ValueError(
                f"sync_mask must be [S]=({num_stages},), "
                f"got {self._sync_mask.shape}"
            )
        self._excess = np.zeros((capacity, world_size, num_stages), dtype)

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    @property
    def baseline(self) -> np.ndarray:
        return self._baseline

    @property
    def num_steps(self) -> int:
        return self._ring.count

    @property
    def steps_seen(self) -> int:
        return self._ring.seen

    def push(self, durations: np.ndarray) -> int:
        """Fold one step matrix d[R, S]; returns the lifetime step index."""
        from .regimes import excess_stream

        d = np.asarray(durations, dtype=np.float64)
        if d.shape != (self.world_size, self.num_stages):
            raise ValueError(
                f"expected [R,S]=({self.world_size},{self.num_stages}), "
                f"got {d.shape}"
            )
        e, _ = excess_stream(d[None], self._baseline, sync_mask=self._sync_mask)
        i = self._ring.advance()
        self._excess[i] = e[0]
        return self._ring.seen - 1

    def push_many(self, durations: np.ndarray) -> int:
        """Fold a whole [N, R, S] block (bit-identical to N pushes —
        the excess rows are per-step independent).  Returns the lifetime
        index of the last folded step."""
        from .regimes import excess_stream

        d = np.asarray(durations, dtype=np.float64)
        if d.ndim != 3 or d.shape[1:] != (self.world_size, self.num_stages):
            raise ValueError(
                f"expected [N,R,S]=(*,{self.world_size},{self.num_stages}), "
                f"got {d.shape}"
            )
        n = d.shape[0]
        if n == 0:
            return self._ring.seen - 1
        keep = min(n, self.capacity)
        e, _ = excess_stream(
            d[n - keep:], self._baseline, sync_mask=self._sync_mask
        )
        idx = (self._ring.next + np.arange(n - keep, n)) % self.capacity
        self._excess[idx] = e
        self._ring.advance(n)
        return self._ring.seen - 1

    def rebase(self, baseline: np.ndarray) -> None:
        """Swap the reference; resets the window (excess rows against the
        old reference are not comparable to new ones)."""
        self._baseline = np.broadcast_to(
            np.asarray(baseline, dtype=np.float64),
            (self.world_size, self.num_stages),
        ).copy()
        self._thresh = self.params.threshold(self._baseline)
        self.reset()

    def reset(self) -> None:
        self._ring.reset()

    def activity(self) -> np.ndarray:
        """[N, R, S] bool — the thresholded activity series over the
        retained steps (chronological).  This is the exact series the
        window statistics reduce, exposed raw because the incident
        tier's cross-job co-activation (`repro.incidents`) correlates
        the *series*, not the per-job reductions."""
        o = self._ring.order()
        return self._excess[o] > self._thresh[None]

    def stats(self):
        """Window `RegimeStats` ([S, R]-oriented, window-relative steps)."""
        from .regimes import regime_stats

        o = self._ring.order()
        return regime_stats(self._excess[o], self._thresh)

    def result(self):
        """Full window classification — identical to the batch pass."""
        from .regimes import (
            RegimeResult,
            classify,
            persistence_weight,
        )

        stats = self.stats()
        return RegimeResult(
            stats=stats,
            labels=classify(stats, self.params),
            weights=persistence_weight(stats, self.params),
            params=self.params,
        )


class WindowStager:
    """Reusable host staging buffers feeding the fused fleet tick.

    Every kernel refresh stacks the dirty jobs' [N, R, S] windows into
    one [J, N, R, S] tensor, pads J to the next power of two (bounded
    jit shapes under elastic churn), and ships it to the device.  Done
    naively that is a fresh `np.stack` allocation per tick; under buffer
    donation the *device* copy is consumed by the kernel, so the host
    staging array is the only piece that can be recycled.  The stager
    keeps one host buffer per padded shape and refills it in place —
    steady-state ticks allocate nothing on the host side.

    The padding rows replicate the last live window (per-job accounting
    is independent along the kernel's grid axis, so live outputs are
    unchanged; callers slice `[:len(windows)]` from the results).
    """

    def __init__(self, max_shapes: int = 32):
        # shape -> staging buffer; tiny LRU so a long-lived service
        # under pathological shape churn stays bounded.
        self._buffers: dict[tuple, np.ndarray] = {}
        self.max_shapes = int(max_shapes)

    @staticmethod
    def padded_jobs(j_live: int) -> int:
        """Next power of two >= j_live (the J the kernel will see)."""
        return 1 << (int(j_live) - 1).bit_length()

    def stage(self, windows) -> np.ndarray:
        """Pack `windows` (same-shape [N, R, S] float32 arrays) into the
        recycled [J_pad, N, R, S] staging buffer and return it."""
        if not windows:
            raise ValueError("stage() needs at least one window")
        j_live = len(windows)
        key = (self.padded_jobs(j_live), *windows[0].shape)
        buf = self._buffers.pop(key, None)
        if buf is None:
            if len(self._buffers) >= self.max_shapes:
                # evict the least-recently-staged shape
                self._buffers.pop(next(iter(self._buffers)))
            buf = np.empty(key, dtype=np.float32)
        self._buffers[key] = buf  # re-insert: most recently used
        for i, w in enumerate(windows):
            buf[i] = w
        buf[j_live:] = buf[j_live - 1]
        return buf

    def clear(self) -> None:
        self._buffers.clear()
