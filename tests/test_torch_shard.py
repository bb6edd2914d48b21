"""The PyTorch port's sharded fleet service against the reference, on CPU.

`repro_torch.fleet.ShardedFleetService` must answer `route`, `snapshot`
and the incident table exactly like the port's single `FleetService`
ingesting the same packets: any shard count (1, 2, 3, 8), either worker
mode, fleets smaller and larger than N, and host- or switch-sharing jobs
forced onto different shards so common-cause promotion must cross the
shard boundary.  Every case is also held against the JAX package's
unsharded `FleetService` on the same wire bytes (one cached run per
scenario): ids, ranks, counts and incident tables exactly, floats within
rtol 1e-4 / atol 1e-7 (the tolerance of `tests/test_torch_fleet.py`).

The reference's 8-device rig (`tests/test_sharded_fleet.py`, forced
host devices for jax) has no CPU counterpart in torch: CPU tensors have
no streams and one device.  Placement is covered here by the device
resolution itself (an explicit list round-robins as given, several cards
spread the shards) and on the card by `chip_smoke.py`'s shard phase.
"""
import dataclasses
import functools
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fleet import FleetService as RefService  # noqa: E402
from repro.fleet.shard import shard_of as ref_shard_of  # noqa: E402
from repro.incidents import IncidentEngine as RefEngine  # noqa: E402
from repro_torch.core import WindowAggregator  # noqa: E402
from repro_torch.fleet import FleetService, ShardedFleetService  # noqa: E402
from repro_torch.fleet.shard import job_id_for_shard, shard_of  # noqa: E402
from repro_torch.incidents import IncidentEngine  # noqa: E402
from repro_torch.sim import simulate  # noqa: E402
from repro_torch.sim.scenarios import fabric_fleet, shared_host_fleet  # noqa: E402
from repro_torch.telemetry.packets import (  # noqa: E402
    EvidencePacket,
    encode_packet,
    from_diagnosis,
)

WINDOW = 20
SHARD_SWEEP = (1, 2, 3, 8)
RTOL, ATOL = 1e-4, 1e-7
#: RouteEntry fields that are float sums (the rest compare exactly)
_FLOAT_FIELDS = ("score", "recoverable_s", "urgency", "persistence")


# -- traffic ----------------------------------------------------------------
# Packets depend only on the scenario, never on the service under test:
# each fleet's wire batches are built once and the same bytes go through
# every service (the port's, sharded or not, and the reference's).


def _encode_windows(fl, windows, drops=None, *, fabric=False) -> tuple:
    drops = drops or {}
    sims = {j: simulate(sc) for j, sc in fl.scenarios.items()}
    aggs = {
        j: WindowAggregator(sc.schema(), window_steps=WINDOW)
        for j, sc in fl.scenarios.items()
    }
    out = []
    for w in range(windows):
        batch = []
        for jid, sc in fl.scenarios.items():
            if w > drops.get(jid, w):
                continue  # job stopped reporting: the eviction path
            block = sims[jid].durations[w * WINDOW:(w + 1) * WINDOW]
            report = None
            for t in range(WINDOW):
                report = aggs[jid].add_step(
                    block[t], block[t].sum(-1)
                ) or report
            extra = (
                dict(switches=sc.switches, pods=sc.pods) if fabric else {}
            )
            pkt = from_diagnosis(
                report.diagnosis, sc.stages, report.steps,
                sc.world_size, report.window_index,
                window=report.durations, sync_stages=sc.sync_stages,
                first_step=w * WINDOW, hosts=sc.hosts, **extra,
            )
            batch.append((jid, encode_packet(pkt, compress="int8")))
        out.append(tuple(batch))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def wire_batches(family, jobs=4, shared_jobs=2, windows=2, seed=1,
                 shard_split=None, drop_after=()) -> tuple:
    """`drop_after`: (job_id, last_window) pairs — the job stops
    reporting after that window (the eviction path)."""
    fl = shared_host_fleet(
        jobs=jobs, shared_jobs=shared_jobs, steps=windows * WINDOW,
        seed=seed, family=family, shard_split=shard_split,
    )
    return _encode_windows(fl, windows, dict(drop_after))


@functools.lru_cache(maxsize=None)
def fabric_wire_batches(family="oversub_uplink", jobs=4, shared_jobs=2,
                        windows=2, seed=1, shard_split=None) -> tuple:
    """Like `wire_batches`, over the tiered `fabric_fleet`: packets carry
    the full SFP2-v3 placement (hosts + switches + pods)."""
    fl = fabric_fleet(
        family, jobs=jobs, shared_jobs=shared_jobs,
        steps=windows * WINDOW, seed=seed, shard_split=shard_split,
    )
    return _encode_windows(fl, windows, fabric=True)


def drive(svc, eng, batches, *, extra_ticks=0):
    """Replay `batches` (+ `extra_ticks` empty ticks) and collect every
    externally observable answer the parity contract covers."""
    routes, snaps = [], []

    def snap():
        # the obs section is the one key with wall-clock state
        s = svc.snapshot()
        s.pop("obs", None)
        return s

    for batch in list(batches) + [()] * extra_ticks:
        svc.submit_many(list(batch), refresh=True)
        svc.tick()
        routes.append(svc.route(10))
        snaps.append(snap())
    incs = (
        tuple(
            (i.incident_id, i.scope, i.tier, i.state, i.host, i.stage,
             i.member_jobs)
            for i in eng.incidents()
        )
        if eng is not None
        else ()
    )
    return routes, snaps, incs


def run_unsharded(batches, *, incidents=True, extra_ticks=0):
    eng = IncidentEngine(device="cpu") if incidents else None
    svc = FleetService(
        window_capacity=WINDOW, evict_after=2, incidents=eng, device="cpu"
    )
    return drive(svc, eng, batches, extra_ticks=extra_ticks)


def run_sharded(batches, shards, *, workers="inline", incidents=True,
                extra_ticks=0):
    eng = IncidentEngine(device="cpu") if incidents else None
    with ShardedFleetService(
        shards=shards, workers=workers, window_capacity=WINDOW,
        evict_after=2, incidents=eng, device="cpu",
    ) as svc:
        return drive(svc, eng, batches, extra_ticks=extra_ticks)


@functools.lru_cache(maxsize=None)
def run_reference(batches, *, incidents=True, extra_ticks=0):
    """The JAX package's unsharded service on the same bytes (one run
    per scenario, shared by every shard count)."""
    eng = RefEngine() if incidents else None
    svc = RefService(window_capacity=WINDOW, evict_after=2, incidents=eng)
    return drive(svc, eng, batches, extra_ticks=extra_ticks)


@functools.lru_cache(maxsize=None)
def port_unsharded(batches, *, incidents=True, extra_ticks=0):
    return run_unsharded(batches, incidents=incidents, extra_ticks=extra_ticks)


def assert_routes_close(got, want):
    """Route entries: every field exact but the float sums, which hold
    RTOL / ATOL."""
    assert len(got) == len(want)
    for g_tick, w_tick in zip(got, want):
        assert len(g_tick) == len(w_tick)
        for g, w in zip(g_tick, w_tick):
            gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
            for name in _FLOAT_FIELDS:
                np.testing.assert_allclose(
                    gd.pop(name), wd.pop(name), rtol=RTOL, atol=ATOL,
                    err_msg=f"{g.job_id} {name}",
                )
            assert gd == wd


def assert_parity(batches, got, **kw):
    """`got` (a sharded run) equals the port's unsharded run exactly and
    the reference's within the float tolerance."""
    mine = port_unsharded(batches, **kw)
    assert got == mine
    routes, snaps, incs = run_reference(batches, **kw)
    assert_routes_close(got[0], routes)
    assert got[1] == snaps
    assert got[2] == incs


# -- the hash partition -----------------------------------------------------


def test_shard_of_matches_the_reference():
    # CRC-32 is process-stable: pin concrete assignments (a change would
    # orphan all live registry state on a rolling restart)
    assert shard_of("job-000", 8) == 3
    assert shard_of("job-001", 8) == 5
    for shards in (1, 2, 3, 8, 11):
        for j in range(50):
            jid = f"job-{j:03d}"
            assert shard_of(jid, shards) == ref_shard_of(jid, shards)
            assert 0 <= shard_of(jid, shards) < shards
    with pytest.raises(ValueError):
        shard_of("x", 0)


def test_job_id_for_shard_hits_requested_shard():
    for shards in (2, 3, 8):
        for target in range(shards):
            jid = job_id_for_shard("job-007", target, shards)
            assert shard_of(jid, shards) == target
            assert jid == job_id_for_shard("job-007", target, shards)
    base = "job-000"
    assert job_id_for_shard(base, shard_of(base, 8), 8) == base
    with pytest.raises(ValueError):
        job_id_for_shard("x", 5, 3)


def test_partition_preserves_per_shard_order():
    svc = ShardedFleetService(shards=3, workers="inline", device="cpu")
    items = [(f"j{i}", b"") for i in range(20)]
    parts = svc.partition(items)
    assert sum(len(p) for p in parts) == len(items)
    for si, part in enumerate(parts):
        assert [shard_of(j, 3) for j, _ in part] == [si] * len(part)
    pos = {j: i for i, (j, _) in enumerate(items)}
    for part in parts:
        idx = [pos[j] for j, _ in part]
        assert idx == sorted(idx)


def test_constructor_rejects_bad_arguments():
    with pytest.raises(ValueError):
        ShardedFleetService(shards=0, device="cpu")
    with pytest.raises(ValueError):
        ShardedFleetService(shards=2, workers="process", device="cpu")
    with pytest.raises(ValueError):
        ShardedFleetService(shards=2, devices="all", device="cpu")


# -- placement --------------------------------------------------------------


def test_explicit_devices_round_robin_as_given():
    devices = [torch.device("cpu", 0), torch.device("cpu", 1)]
    svc = ShardedFleetService(shards=5, workers="inline", device="cpu",
                              devices=devices)
    assert [s.device for s in svc.shards] == [devices[i % 2] for i in range(5)]
    # CPU shards have no streams: nothing to enter around their calls
    assert svc._streams == [None] * 5
    batches = wire_batches("step")
    assert drive(svc, None, batches)[:2] == port_unsharded(
        batches, incidents=False)[:2]


def test_auto_spreads_shards_over_every_card(monkeypatch):
    """`devices="auto"` with four cards: cuda:0..3 round-robin; with one
    card, or with None, every shard takes `device`."""
    svc = ShardedFleetService(shards=1, workers="inline", device="cpu")
    svc.n_shards = 6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = svc._resolve_devices("cuda", "auto")
    assert got == [torch.device("cuda", i % 4) for i in range(6)]
    assert svc._resolve_devices("cuda", None) == [torch.device("cuda")] * 6
    assert svc._resolve_devices("cpu", "auto") == [torch.device("cpu")] * 6
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert svc._resolve_devices("cuda", "auto") == [torch.device("cuda")] * 6


# -- the differential -------------------------------------------------------


@pytest.mark.parametrize("shards", SHARD_SWEEP)
@pytest.mark.parametrize("family", ["step", "drift", "intermittent", "blip"])
def test_bit_identical_per_family(family, shards):
    """Every scenario family, every shard count: routes, snapshots, and
    the incident table match the unsharded service exactly."""
    batches = wire_batches(family)
    assert_parity(batches, run_sharded(batches, shards))


@pytest.mark.parametrize("shards", SHARD_SWEEP)
@pytest.mark.parametrize("workers", ["inline", "thread"])
def test_worker_modes_agree(workers, shards):
    """Thread lanes change wall-clock only: outputs are identical to the
    inline reference."""
    batches = wire_batches("step", shard_split=3)
    assert_parity(batches, run_sharded(batches, shards, workers=workers))


@pytest.mark.parametrize("jobs,shards", [(2, 8), (12, 3)])
def test_jobs_below_and_above_shard_count(jobs, shards):
    """J < N leaves shards empty; J > N packs several jobs per shard —
    both must be invisible in the answers."""
    batches = wire_batches("step", jobs=jobs, shared_jobs=2)
    assert_parity(batches, run_sharded(batches, shards, workers="thread"))


@pytest.mark.parametrize("shards", [2, 8])
def test_eviction_differential(shards):
    """A job that stops reporting evicts on ITS shard at the same tick
    (and with the same incident resolution) as unsharded."""
    batches = wire_batches(
        "step", jobs=4, windows=3, drop_after=(("job-000", 0),)
    )
    got = run_sharded(batches, shards, extra_ticks=3)
    assert_parity(batches, got, extra_ticks=3)
    assert got[1][-1]["evicted_total"] >= 1


# -- route-merge tie order --------------------------------------------------


def test_route_merge_tie_order_across_shards():
    """Jobs with IDENTICAL traffic on different shards score the same;
    the merged route must order them by (job_id, rank), exactly as the
    unsharded sort does, not by shard position."""
    fl = shared_host_fleet(
        jobs=1, shared_jobs=0, steps=2 * WINDOW, seed=7,
        distractor_family="step",
    )
    (_, sc), = fl.scenarios.items()
    res = simulate(sc)
    clones = [job_id_for_shard(f"tie-{c}", c % 3, 3) for c in range(4)]
    assert len({shard_of(j, 3) for j in clones}) == 3
    batches = []
    for w in range(2):
        batch = []
        for jid in clones:
            agg = WindowAggregator(sc.schema(), window_steps=WINDOW)
            block = res.durations[w * WINDOW:(w + 1) * WINDOW]
            report = None
            for t in range(WINDOW):
                report = agg.add_step(block[t], block[t].sum(-1)) or report
            pkt = from_diagnosis(
                report.diagnosis, sc.stages, report.steps, sc.world_size,
                report.window_index, window=report.durations,
                sync_stages=sc.sync_stages, first_step=w * WINDOW,
            )
            batch.append((jid, encode_packet(pkt, compress="int8")))
        batches.append(tuple(batch))
    batches = tuple(batches)
    got = run_sharded(batches, 3, workers="thread", incidents=False)
    assert_parity(batches, got, incidents=False)
    final = got[0][-1]
    assert len(final) == len(clones)
    assert len({e.score for e in final}) == 1, "clones must tie"
    assert [e.job_id for e in final] == sorted(e.job_id for e in final)


# -- cross-shard incidents --------------------------------------------------


def test_cross_shard_common_cause_promotes_once():
    """Host-sharing jobs forced onto DIFFERENT shards still promote
    exactly one fleet-scoped incident on the shared host — through the
    cross-shard activity reduce."""
    batches = wire_batches("step", shard_split=3)
    fl = shared_host_fleet(
        jobs=4, shared_jobs=2, steps=2 * WINDOW, seed=1, family="step",
        shard_split=3,
    )
    owners = {shard_of(j, 3) for j in fl.shared_job_ids}
    assert len(owners) == len(fl.shared_job_ids) >= 2
    eng = IncidentEngine(device="cpu")
    with ShardedFleetService(shards=3, workers="thread", window_capacity=WINDOW,
                             evict_after=2, incidents=eng, device="cpu") as svc:
        got = drive(svc, eng, batches)
    fleet = [i for i in eng.incidents() if i.scope == "fleet"]
    assert len(fleet) == 1
    assert fleet[0].host == fl.shared_host
    assert fleet[0].member_jobs == tuple(sorted(fl.shared_job_ids))
    assert_parity(batches, got)


@pytest.mark.parametrize("shards", SHARD_SWEEP)
@pytest.mark.parametrize(
    "family,tier", [("oversub_uplink", "switch"), ("pod_congestion", "pod")]
)
def test_fabric_tier_bit_identical(family, tier, shards):
    """Tier promotion through the cross-shard reduce: every shard count
    produces the SAME fabric-tier fleet incident as unsharded."""
    batches = fabric_wire_batches(family)
    got = run_sharded(batches, shards)
    assert_parity(batches, got)
    fleet = [row for row in got[2] if row[1] == "fleet"]
    assert len(fleet) == 1 and fleet[0][2] == tier


@pytest.mark.parametrize("workers", ["inline", "thread"])
def test_cross_shard_switch_promotes_once(workers):
    """The uplink-sharing jobs forced onto DIFFERENT shards still promote
    exactly one switch-tier incident on the shared uplink."""
    batches = fabric_wire_batches("oversub_uplink", shard_split=3)
    fl = fabric_fleet(
        "oversub_uplink", jobs=4, shared_jobs=2, steps=2 * WINDOW,
        seed=1, shard_split=3,
    )
    owners = {shard_of(j, 3) for j in fl.member_job_ids}
    assert len(owners) == len(fl.member_job_ids) >= 2
    got = run_sharded(batches, 3, workers=workers)
    fleet = [row for row in got[2] if row[1] == "fleet"]
    assert len(fleet) == 1
    assert fleet[0][2] == "switch" and fleet[0][4] == fl.node
    assert fleet[0][6] == tuple(sorted(fl.member_job_ids))
    assert_parity(batches, got)


def test_eviction_on_one_shard_never_resurrects_anothers_incident():
    """Shard A's job departs and evicts; shard B's incident keeps its own
    lifecycle — live on ITS evidence (table identical to unsharded)."""
    fl = shared_host_fleet(
        jobs=4, shared_jobs=2, steps=3 * WINDOW, seed=1, family="step",
        shard_split=3,
    )
    a, b = fl.shared_job_ids[:2]
    assert shard_of(a, 3) != shard_of(b, 3)
    dropped = wire_batches(
        "step", jobs=4, windows=3, shard_split=3, drop_after=((a, 1),)
    )
    got = run_sharded(dropped, 3, workers="thread")
    assert_parity(dropped, got)
    assert got[1][-1]["evicted_total"] == 1  # a, and only a
    b_states = {st for iid, _scope, _tier, st, *_ in got[2]
                if iid.startswith(f"ij:{b}:")}
    assert "active" in b_states or "open" in b_states, got[2]


# -- the topology the lanes declare into ------------------------------------


def test_lanes_declare_into_the_engine_topology_one_at_a_time():
    """Thread lanes declare placements concurrently into the coordinator
    engine's topology: its writes are locked, so no re-homing count is
    lost."""
    eng = IncidentEngine(device="cpu")
    topo = eng.topology
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def flip(k):
            for i in range(200):
                # jobs j0..j7 swap between two hosts every call
                topo.declare(f"j{k}", (f"h{(i + k) % 2}",))
        threads = [threading.Thread(target=flip, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    # every call after a job's first re-homes its one rank
    assert eng.topology.rehomed == 8 * 199


# -- properties (hypothesis) ------------------------------------------------

STAGES = ("s0", "s1")
JOB_IDS = ("a", "b", "c", "d", "e", "f")
PROP_SHARDS = (1, 2, 3, 5)


def mk_packet(window_index: int, gain: float = 0.1, *, steps=4, ranks=2):
    """Predecoded packet (no wire, no window): churn and routing without
    kernel work.  `gain` sets the routing score — drawn from a small set
    so cross-shard score ties are common."""
    return EvidencePacket(
        window_index=window_index, schema_hash="h0", stages=STAGES,
        steps=steps, world_size=ranks, gather_ok=True, labels=(),
        routing_stages=("s0",), shares=(0.6, 0.4), gains=(gain, 0.0),
        co_critical_stages=(), downgrade_reasons=(), leader_rank=0,
        exposed_total=float(steps * 0.02),
    )


def observable(svc) -> tuple:
    snap = svc.snapshot()
    snap.pop("obs", None)
    return (
        [(e.job_id, e.stage, e.rank, e.score)
         for e in svc.route(len(JOB_IDS) + 2)],
        snap,
    )


def run_service(svc, batches) -> list:
    out = []
    for batch in batches:
        svc.submit_many(batch)
        svc.tick()
        out.append(observable(svc))
    if isinstance(svc, ShardedFleetService):
        svc.close()
    return out


def materialize(raw) -> list:
    return [[(job, mk_packet(wi, gain)) for job, wi, gain in tick_batch]
            for tick_batch in raw]


def _strategies():
    st = pytest.importorskip("hypothesis.strategies")
    batch = st.lists(
        st.tuples(st.sampled_from(JOB_IDS), st.integers(0, 3),
                  st.sampled_from([0.1, 0.2])),
        max_size=len(JOB_IDS), unique_by=lambda t: t[0],
    )
    return st, st.lists(batch, min_size=1, max_size=5)


def test_outputs_invariant_to_shard_count():
    hypothesis = pytest.importorskip("hypothesis")
    st, batches_st = _strategies()

    @hypothesis.settings(max_examples=40, deadline=None)
    @hypothesis.given(batches_st, st.sampled_from(PROP_SHARDS))
    def prop(raw, shards):
        batches = materialize(raw)
        ref = run_service(FleetService(evict_after=2, device="cpu"), batches)
        got = run_service(
            ShardedFleetService(shards=shards, workers="inline",
                                evict_after=2, device="cpu"),
            batches,
        )
        assert got == ref

    prop()


def test_outputs_invariant_to_submission_interleaving():
    hypothesis = pytest.importorskip("hypothesis")
    st, batches_st = _strategies()

    @hypothesis.settings(max_examples=40, deadline=None)
    @hypothesis.given(
        batches_st.filter(lambda bs: any(len(b) > 1 for b in bs)),
        st.randoms(use_true_random=False),
        st.sampled_from(PROP_SHARDS),
    )
    def prop(raw, rng, shards):
        batches = materialize(raw)
        shuffled = [list(b) for b in batches]
        for b in shuffled:
            rng.shuffle(b)

        def run(bs):
            return run_service(
                ShardedFleetService(shards=shards, workers="thread",
                                    evict_after=2, device="cpu"),
                bs,
            )

        assert run(shuffled) == run(batches)

    prop()


def test_churn_counters_exact_across_shards():
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    churn_op = st.one_of(
        st.tuples(st.just("pkt"), st.sampled_from(JOB_IDS),
                  st.integers(0, 3)),
        st.tuples(st.just("tick"), st.none(), st.none()),
    )

    @hypothesis.settings(max_examples=60, deadline=None)
    @hypothesis.given(st.lists(churn_op, min_size=1, max_size=40),
                      st.sampled_from(PROP_SHARDS))
    def prop(ops, shards):
        svc = ShardedFleetService(shards=shards, workers="inline",
                                  evict_after=2, device="cpu")
        # an independent model of the counters (same eviction window)
        tick = 0
        last_wi: dict[str, int] = {}
        last_seen: dict[str, int] = {}
        expected_windows = packets_sent = 0
        for kind, job, wi in ops:
            if kind == "tick":
                svc.tick()
                tick += 1
                for j in [j for j, t in last_seen.items() if tick - t >= 2]:
                    del last_seen[j], last_wi[j]
            else:
                svc.submit(job, mk_packet(wi))
                packets_sent += 1
                if last_wi.get(job) != wi:
                    expected_windows += 1
                    last_wi[job] = wi
                last_seen[job] = tick
            snap = svc.snapshot()
            assert snap["windows_seen"] == expected_windows
            assert snap["duplicate_total"] == packets_sent - expected_windows
        # the per-shard registries partition the live set
        assert sum(len(s.registry) for s in svc.shards) == len(svc)
        assert len(svc) == len(last_seen)
        svc.close()

    prop()


# -- self-observability -----------------------------------------------------


def _obs_batch(tick: int, jobs: int = 6) -> list:
    return [(f"job-{j}", mk_packet(tick)) for j in range(jobs)]


def test_merged_obs_section():
    with ShardedFleetService(shards=3, workers="thread",
                             device="cpu") as svc:
        for t in range(3):
            svc.submit_many(_obs_batch(t))
            svc.tick()
        snap = svc.snapshot()
    obs = snap["obs"]
    assert obs["metrics"]["counters"]["packets"] == snap["packets"]
    # "ticks" sums over every registry in the merge: 3 shards + coord
    assert obs["metrics"]["counters"]["ticks"] == 4 * snap["tick"]
    tf = obs["tick_frontier"]
    assert tf["shards"] == ["shard-0", "shard-1", "shard-2", "coord"]
    assert tf["ticks"] == 3


def _stalled_trial(stall_shard: int, stall_s: float = 0.02) -> tuple:
    """Fresh 3-shard threaded service with a sleep smuggled into one
    shard's wire-decode lane; returns the frontier's (shard, phase)."""
    svc = ShardedFleetService(shards=3, workers="thread", device="cpu")
    victim = svc.shards[stall_shard]
    inner = victim.ingest.decode_many

    def slow_decode_many(items):
        time.sleep(stall_s)
        return inner(items)

    victim.ingest.decode_many = slow_decode_many
    try:
        for t in range(3):
            svc.submit_many(_obs_batch(t))
            svc.tick()
        tf = svc.snapshot()["obs"]["tick_frontier"]
        return tf["slowest"]["shard"], tf["slowest"]["phase"]
    finally:
        svc.close()


def test_injected_shard_stall_attributed():
    """A sleep in one shard's decode lane is named by shard AND phase in
    >= 9/10 independent trials on the threaded coordinator."""
    hits = sum(
        _stalled_trial(stall_shard=1) == ("shard-1", "tick.decode")
        for _ in range(10)
    )
    assert hits >= 9, f"stall attributed in only {hits}/10 trials"
