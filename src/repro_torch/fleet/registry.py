"""Per-job registry: bounded streaming state for every job in the fleet.

Each registered job owns a `StreamingFrontier` (O(window * S) state — the
[N, R, S] window matrices are folded step-by-step and dropped, never
accumulated), the last decoded packet summary, and liveness counters that
mirror the failure-safe gather semantics of `repro.telemetry.gather`:

  * a job whose packets report ``gather_ok=False`` accumulates a missing
    streak; past ``degrade_after`` consecutive windows the job is marked
    degraded and its absent ranks are recorded as dead (the fleet analogue
    of the fail-slow -> fail-stop promotion in `distributed.policy`);
  * a job that stops reporting entirely for ``evict_after`` ticks is
    evicted — symmetric failure-safe collection, bounded registry.

Degraded jobs stay visible (operators need to see them) but are excluded
from profiler routing: telemetry-quality labels never trigger
workload-touching actions.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.regimes import REGIME_NAMES, RegimeCall
from ..core.streaming import StreamingFrontier, StreamingRegimes
from ..core.whatif import make_sync_mask
from ..telemetry.packets import EvidencePacket

__all__ = ["JobState", "FleetRegistry"]

_STRONG_LABELS = frozenset(
    {"direct_exposure", "sync_wait_dependent", "likely_sync_wait"}
)


@dataclasses.dataclass
class JobState:
    """Mutable per-job record held by the registry."""

    job_id: str
    stages: tuple[str, ...]
    world_size: int
    schema_hash: str
    streaming: StreamingFrontier
    #: declared sync profile (stage names ending in a group barrier) — set
    #: from the job's packets; drives the counterfactual replay model.
    sync_stages: tuple[str, ...] = ()
    #: declared per-rank host placement (SFP2-v2 host section); feeds the
    #: incident tier's `Topology`.  () = the job never declared one.
    hosts: tuple[str, ...] = ()
    #: last full [N, R, S] window (f32, only when packets ship windows);
    #: feeds the batched fleet-kernel refresh, which releases it — raw
    #: windows are consumed, never accumulated.
    last_window: np.ndarray | None = None
    last_packet: EvidencePacket | None = None
    last_tick: int = 0
    windows_seen: int = 0
    missing_streak: int = 0
    dead_ranks: frozenset[int] = frozenset()
    degraded: bool = False
    #: kernel-refreshed per-stage shares/gains ([S] each, None until a
    #: batched refresh has covered this job).
    kernel_shares: np.ndarray | None = None
    kernel_gains: np.ndarray | None = None
    kernel_leader: int = -1
    #: kernel-refreshed counterfactual what-if matrix W[S, R] (recoverable
    #: seconds per (stage, rank) candidate); None until a batched refresh
    #: has covered this job.
    whatif: np.ndarray | None = None
    #: incremental temporal regime engine over the job's pushed windows —
    #: spans multiple evidence packets (the temporal question needs a
    #: history longer than one window).  None until the first raw window
    #: arrives; the reference is fixed from that window's cohort median
    #: (a moving reference would make early/late folds disagree).
    regimes: StreamingRegimes | None = None
    #: job-global step index of the regime stream's first pushed step
    #: (from the first packet's declared `first_step`; 0 when packets
    #: predate the field) — converts window-relative onsets to job steps.
    step_origin: int = 0
    #: sync profile the regime stream was built with; a later packet
    #: declaring a different profile rebuilds the stream (the imputation
    #: semantics of its excess rows changed, old history not comparable).
    regime_sync: tuple[str, ...] = ()
    #: cached `RegimeResult` of `regimes` (invalidated on every ingest).
    _regime_cache: object = None

    @property
    def labels(self) -> tuple[str, ...]:
        return self.last_packet.labels if self.last_packet else ()

    def sync_index_tuple(self) -> tuple[int, ...]:
        """Declared sync stages as ordered stage indices (kernel static
        arg and batched-refresh group key; unknown names are ignored)."""
        return tuple(
            i for i, s in enumerate(self.stages) if s in set(self.sync_stages)
        )

    @property
    def has_strong_evidence(self) -> bool:
        return bool(_STRONG_LABELS & set(self.labels))

    def shares(self) -> np.ndarray:
        """Freshest per-stage shares: kernel > streaming > packet header."""
        if self.kernel_shares is not None:
            return self.kernel_shares
        if self.streaming.num_steps:
            return self.streaming.shares()
        if self.last_packet is not None:
            return np.asarray(self.last_packet.shares)
        return np.zeros(len(self.stages))

    def urgency(self) -> float:
        """Scalar 'how much does this job need a heavy profiler' score."""
        if self.degraded or self.last_packet is None:
            return 0.0
        sh = self.shares()
        top_share = float(sh.max()) if sh.size else 0.0
        top_gain = max(self.last_packet.gains, default=0.0)
        if self.kernel_gains is not None and self.kernel_gains.size:
            top_gain = max(top_gain, float(self.kernel_gains.max()))
        return (2.0 if self.has_strong_evidence else 0.0) + top_share + top_gain

    def recoverable(self) -> tuple[float, int, int]:
        """Estimated recoverable seconds and the candidate that yields them.

        Returns ``(seconds, stage_index, rank)``.  Evidence ladder,
        freshest first (one source per answer — never a stage from one
        window paired with another window's rank):

          1. kernel what-if matrix: the exact counterfactual, argmax cell;
          2. packet gains x a window denominator: the whole-stage clipped
             gain converted to seconds (a stage-level estimate).  The rank
             is the packet's own leader *only when* the gain-argmax stage
             is also the packet's top routing stage — the leader belongs
             to the packet's routing answer, and pairing it with some
             other stage would violate the one-source rule; otherwise the
             rank is reported unknown (-1).  The denominator is the
             packet's own `exposed_total` when declared, else the
             streaming state's summed exposed makespan (packets from
             pre-whatif emitters decode with exposed_total = -1);
          3. gains with no denominator anywhere (compact pre-whatif
             packets): the top gain *fraction* stands in as the score —
             dimensionless, so such jobs rank conservatively against
             seconds-priced peers, but they stay routable;
          4. nothing usable: (0.0, -1, -1).

        Degraded jobs report 0.0 — quality labels never route profilers.
        """
        if self.degraded:
            return 0.0, -1, -1
        if self.whatif is not None and self.whatif.size:
            flat = int(np.argmax(self.whatif))
            si, ri = divmod(flat, self.whatif.shape[1])
            return float(self.whatif[si, ri]), si, ri
        pkt = self.last_packet
        if pkt is not None and pkt.gains:
            si = int(np.argmax(pkt.gains))
            denom = pkt.exposed_total
            if denom <= 0.0 and self.streaming.num_steps:
                denom = self.streaming.exposed_total()
            scale = denom if denom > 0.0 else 1.0
            rec = float(pkt.gains[si]) * scale
            stage_name = self.stages[si] if si < len(self.stages) else ""
            ri = (
                pkt.leader_rank
                if pkt.routing_stages and pkt.routing_stages[0] == stage_name
                else -1
            )
            if rec > 0.0:
                return rec, si, ri
        return 0.0, -1, -1

    # -- temporal regime state --------------------------------------------

    def regime_result(self):
        """Window `RegimeResult` of the job's regime stream, cached until
        the next ingest; None when no window has ever been pushed (or the
        stream is empty)."""
        if self.regimes is None or not self.regimes.num_steps:
            return None
        if self._regime_cache is None:
            self._regime_cache = self.regimes.result()
        return self._regime_cache

    def regime_call(self, stage: int, rank: int) -> RegimeCall | None:
        """Temporal classification of one candidate, with the onset
        converted to job-global step coordinates.  None when the job has
        no regime evidence (compact packets, empty stream, or a candidate
        outside the matrix)."""
        res = self.regime_result()
        if res is None:
            return None
        if not (
            0 <= stage < res.labels.shape[0] and 0 <= rank < res.labels.shape[1]
        ):
            return None
        call = res.call(stage, rank)
        if call.onset >= 0:
            # ring-relative -> stream-relative -> job-global steps
            dropped = self.regimes.steps_seen - self.regimes.num_steps
            call = dataclasses.replace(
                call, onset=self.step_origin + dropped + call.onset
            )
        return call

    def persistence(self, stage: int, rank: int) -> float | None:
        """Persistence weight of one candidate in [0, 1]; None when the
        job has no regime evidence (callers treat unknown as 1.0 — a
        fault of unknown temporal state must not be deprioritized)."""
        res = self.regime_result()
        if res is None:
            return None
        if not (
            0 <= stage < res.weights.shape[0] and 0 <= rank < res.weights.shape[1]
        ):
            return None
        return float(res.weights[stage, rank])

    def regime_counts(self) -> dict[str, int]:
        """Live candidates per temporal class (all-`none` when unknown)."""
        res = self.regime_result()
        if res is None:
            return {name: 0 for name in REGIME_NAMES}
        return res.counts()


class FleetRegistry:
    """Bounded job table with tick-based liveness."""

    def __init__(self, *, window_capacity: int = 100, evict_after: int = 10,
                 degrade_after: int = 3, max_jobs: int = 100_000,
                 regime_windows: int = 4):
        self.window_capacity = window_capacity
        self.evict_after = evict_after
        self.degrade_after = degrade_after
        self.max_jobs = max_jobs
        #: regime-stream depth in window_capacity multiples: the temporal
        #: question needs a history longer than one window, so each job's
        #: StreamingRegimes retains `regime_windows * window_capacity`
        #: steps (bounded — the excess ring is O(capacity * R * S)).
        self.regime_windows = max(1, regime_windows)
        self.rejected_total = 0
        self.duplicate_total = 0
        #: windows accepted over the registry's lifetime.  Monotonic by
        #: construction — eviction and schema restarts never decrement it
        #: (per-job `windows_seen` resets with the job; summing it across
        #: live jobs made the fleet counter run *backwards* whenever a
        #: job was evicted).
        self.windows_total = 0
        self._jobs: dict[str, JobState] = {}

    # -- updates -----------------------------------------------------------

    def update(
        self, job_id: str, pkt: EvidencePacket, tick: int
    ) -> JobState | None:
        """Fold one decoded packet into the job's state (creates the job).

        Returns None when the registry is full and `job_id` is new: bounded
        state means refusing registrations, never silently deleting a live
        job.  Refusals are counted in `rejected_total`.
        """
        job = self._jobs.get(job_id)
        if job is None or job.schema_hash != pkt.schema_hash:
            if job is None and len(self._jobs) >= self.max_jobs:
                self.rejected_total += 1
                return None
            # new job, or schema break: restart the stream (Table 11 rule —
            # never merge rows across schema hashes).
            job = JobState(
                job_id=job_id,
                stages=tuple(pkt.stages),
                world_size=pkt.world_size,
                schema_hash=pkt.schema_hash,
                streaming=StreamingFrontier(
                    pkt.world_size, len(pkt.stages),
                    capacity=self.window_capacity,
                ),
                sync_stages=tuple(pkt.sync_stages),
            )
            self._jobs[job_id] = job
        elif (
            job.last_packet is not None
            and pkt.window_index == job.last_packet.window_index
        ):
            # transport retry re-delivered a window already folded: refresh
            # liveness only, never double-count the window.
            self.duplicate_total += 1
            job.last_tick = tick
            return job
        job.last_tick = tick
        job.windows_seen += 1
        self.windows_total += 1
        job.last_packet = pkt
        if pkt.sync_stages:
            job.sync_stages = tuple(pkt.sync_stages)
        if pkt.hosts:
            job.hosts = tuple(pkt.hosts)
        # Any accepted packet is fresher evidence than a kernel refresh
        # computed from an older window: invalidate the refreshed state so
        # `recoverable()`/`shares()` fall to the packet (or the next
        # refresh) instead of serving a stale matrix forever.
        job.kernel_shares = None
        job.kernel_gains = None
        job.kernel_leader = -1
        job.whatif = None
        job._regime_cache = None

        if pkt.gather_ok:
            job.missing_streak = 0
            job.degraded = False
            job.dead_ranks = frozenset()   # a healthy gather clears the set
        else:
            job.missing_streak += 1
            if job.missing_streak >= self.degrade_after:
                job.degraded = True
                if pkt.present_ranks:
                    job.dead_ranks = frozenset(
                        set(range(pkt.world_size)) - set(pkt.present_ranks)
                    )

        if pkt.window is not None:
            w = np.asarray(pkt.window, np.float64)
            if w.ndim == 3 and w.shape[1:] == (pkt.world_size, len(pkt.stages)):
                job.streaming.push_many(w)
                self._fold_regimes(job, pkt, w)
                # f32 is what the kernel consumes; half the pinned bytes,
                # and refresh_batched() releases it after the refresh.
                job.last_window = w.astype(np.float32)
        return job

    def _fold_regimes(
        self, job: JobState, pkt: EvidencePacket, w: np.ndarray
    ) -> None:
        """Fold one raw window into the job's temporal regime stream.

        The stream is only meaningful over a *contiguous* step history
        with a *fixed* imputation profile, so it restarts (never
        silently stitches) when either breaks:

          * the declared sync profile changed since the stream was
            built — the excess rows' imputation semantics changed, so
            old history is not comparable (same contract as
            `StreamingRegimes.rebase`);
          * the packet's declared `first_step` does not equal the next
            expected step — a dropped window, a compact packet in
            between, or reordering; stitching non-adjacent steps would
            corrupt onsets and promote two distant bursts into one
            contiguous run.  Legacy packets (`first_step == -1`) cannot
            declare coordinates and are folded as contiguous.
        """
        sync_key = tuple(job.sync_stages)
        if job.regimes is not None and sync_key != job.regime_sync:
            job.regimes = None
        if job.regimes is not None and pkt.first_step >= 0:
            expected = job.step_origin + job.regimes.steps_seen
            if pkt.first_step != expected:
                job.regimes = None
        if job.regimes is None:
            # reference fixed from this window's cohort median of the
            # sync-imputed work (the same default the batch engine
            # derives); later windows fold against it so early/late
            # folds agree.  float32 ring: at fleet scale the excess
            # history is the registry's dominant pinned state, and the
            # classification thresholds are far above f32 resolution
            # (the engine-level bit-for-bit contract is property-tested
            # at the default float64).
            from ..core.regimes import excess_stream

            mask = (
                make_sync_mask(job.stages, job.sync_stages)
                if job.sync_stages
                else None
            )
            _, base = excess_stream(w, sync_mask=mask)
            job.regimes = StreamingRegimes(
                job.world_size,
                len(job.stages),
                base,
                capacity=self.window_capacity * self.regime_windows,
                sync_mask=mask,
                dtype=np.float32,
            )
            job.step_origin = max(0, pkt.first_step)
            job.regime_sync = sync_key
        job.regimes.push_many(w)

    def evict_stale(self, tick: int) -> list[str]:
        """Drop jobs silent for >= evict_after ticks; returns evicted ids."""
        stale = [
            jid for jid, j in self._jobs.items()
            if tick - j.last_tick >= self.evict_after
        ]
        for jid in stale:
            del self._jobs[jid]
        return stale

    # -- reads -------------------------------------------------------------

    def get(self, job_id: str) -> JobState | None:
        return self._jobs.get(job_id)

    def jobs(self) -> list[JobState]:
        return list(self._jobs.values())

    def dirty_groups(self) -> dict[tuple, list[JobState]]:
        """Dirty window-carrying jobs grouped by batching key.

        Dirty = a raw window arrived since the last kernel refresh (the
        registry nulls `kernel_shares` on ingest).  Jobs are grouped by
        (window shape, declared sync profile): windows stack into one
        [J, N, R, S] tensor only when shapes agree, and the sync
        segmentation is a static kernel argument that must match within
        a batch.  Degraded jobs are skipped — their telemetry is not
        trusted enough to spend kernel time on."""
        groups: dict[tuple, list[JobState]] = {}
        for job in self._jobs.values():
            if (
                job.last_window is not None
                and not job.degraded
                and job.kernel_shares is None
            ):
                key = (job.last_window.shape, job.sync_index_tuple())
                groups.setdefault(key, []).append(job)
        return groups

    def __len__(self) -> int:
        return len(self._jobs)

    def __contains__(self, job_id: str) -> bool:
        return job_id in self._jobs
