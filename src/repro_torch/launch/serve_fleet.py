"""Fleet aggregation serving driver: many jobs -> one routing answer.

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet \
        --jobs 12 --ranks 8 --window 20 --rounds 4 --top-k 3

Simulates a heterogeneous fleet (DDP / FSDP / ZeRO-1 sync profiles, E3
fault families on a subset of jobs, one job that dies, one whose gather
degrades), runs each job's windows through the standard WindowAggregator,
ships the resulting evidence packets over the int8 wire format, and drives
a `FleetService`: ingest -> tick/evict -> batched kernel refresh (frontier
+ counterfactual what-if, the CUDA tick kernel) -> top-K
persistence-weighted recoverable-time routing.  Prints a JSON summary (the
serving response shape): each routing entry carries the estimated
recoverable seconds a fix at its (stage, rank) is worth, plus the fault's
temporal regime (transient/recurring/persistent), persistence weight and
onset step.

With `--topology private|shared|fabric` the packets additionally
declare each job's rank->host placement (SFP2-v2 host section; `fabric`
adds the per-rank switch/pod tiers as SFP2-v3 sections) and the
incident tier runs on top: the summary gains a durable `incidents`
table (lifecycle, exposure since onset, fleet-level common-cause
incidents promoted to the narrowest explaining tier — `shared` yields a
host incident, `fabric` a switch incident on the shared uplink) and an
`escalations` list (the budgeted profiler-attachment plan; at most
`--budget` per tick).

`--device cuda` (the default) runs the tick kernel and the co-activation
kernel on the GPU and raises where there is none; `--device cpu` runs
their plain torch versions.  `--shards N` serves through a
`ShardedFleetService` (N shards, each on a CUDA stream of its own, with
the incident tier at the coordinator); its answers equal the
single-process service's.  `--max-windows` bounds each job's retained
temporal history (memory knob for very long runs).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from ..core import WindowAggregator
from ..fleet import FleetService, ShardedFleetService
from ..incidents import EscalationController, IncidentEngine
from ..sim import ClusterSpec, simulate
from ..sim.scenarios import (
    DDP_SYNC,
    E3_FAMILIES,
    FSDP_SYNC,
    ZERO1_SYNC,
    ddp_scenario,
    hidden_fault_rank,
    hidden_rank_scenario,
)
from ..telemetry.packets import encode_packet, from_diagnosis

SYNC_PROFILES = {
    "ddp": DDP_SYNC,
    "fsdp": FSDP_SYNC,
    "zero1": ZERO1_SYNC,
}

#: host name shared by every faulted job's faulted rank under
#: --topology shared (the injected common cause).
SHARED_HOST = "shared-0"

#: fabric nodes shared by every faulted job's faulted rank under
#: --topology fabric: each faulted rank keeps its own PRIVATE host, but
#: all those hosts hang under one switch (the oversubscribed-uplink
#: shape) — the incident engine must promote ONE switch-tier incident.
SHARED_SWITCH = "fab-sw0"
SHARED_POD = "fab-pod0"


def make_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--jobs", type=int, default=12)
    p.add_argument("--ranks", type=int, default=8)
    p.add_argument("--window", type=int, default=20)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--top-k", type=int, default=3)
    p.add_argument("--delay-ms", type=float, default=150.0)
    p.add_argument("--fault-every", type=int, default=3,
                   help="every K-th job gets an injected E3 fault")
    p.add_argument("--compress", default="int8",
                   choices=["none", "int8", "int8.delta"])
    p.add_argument("--wire", default="sfp2", choices=["sfp1", "sfp2"],
                   help="wire framing (sfp1 = legacy back-compat route; "
                        "int8.delta requires sfp2)")
    p.add_argument("--topology", default="none",
                   choices=["none", "private", "shared", "fabric"],
                   help="declare per-job host placement in the packets "
                        "(SFP2-v2 host section) and run the incident "
                        "tier: 'private' packs 2 ranks/host per job; "
                        "'shared' additionally re-homes every faulted "
                        "job's faulted rank onto one fleet-shared host "
                        "(and pins faulted jobs to the 'data' family, "
                        "so the common cause is a single host+stage "
                        "the incident engine must promote); 'fabric' "
                        "keeps each faulted rank on its own host but "
                        "hangs all those hosts under one shared switch "
                        "(per-rank switch/pod SFP2-v3 sections) — the "
                        "engine must promote ONE switch-tier incident, "
                        "never per-host duplicates")
    p.add_argument("--budget", type=int, default=2,
                   help="profiler escalations per tick "
                        "(EscalationController token budget)")
    p.add_argument("--max-windows", type=int, default=None,
                   help="bound per-job temporal history: the registry "
                        "retains at most this many windows of regime "
                        "state per job (pass-through to FleetRegistry "
                        "regime_windows; default 4).  The knob that "
                        "bounds memory on very long runs")
    p.add_argument("--shards", type=int, default=None,
                   help="serve through a ShardedFleetService with this "
                        "many worker shards (stable job-id hash "
                        "partition; answers are bit-identical to the "
                        "default single-process service).  Each shard "
                        "launches its kernels on a CUDA stream of its "
                        "own; with several CUDA devices visible the "
                        "shards are spread over them")
    p.add_argument("--shard-workers", default="thread",
                   choices=["thread", "inline"],
                   help="per-shard execution lanes under --shards: "
                        "'thread' overlaps wire decode with kernel "
                        "launches across shards; 'inline' runs shards "
                        "one after another (the deterministic debugging "
                        "reference: same outputs, only wall-clock "
                        "differs)")
    p.add_argument("--obs", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="self-observability (obs): tick-phase "
                        "frontier over the service's own pipeline, "
                        "metrics registry, flight recorder — surfaced "
                        "as a top-level 'obs' section in the JSON "
                        "summary.  On by default; --no-obs turns it off")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels run: 'cuda' (the hand-written "
                        "tick and co-activation kernels; raises without a "
                        "GPU) or 'cpu' (their plain torch versions)")
    return p


def _cluster_for(args, j: int, faulted: bool) -> ClusterSpec | None:
    """Per-job placement under --topology (None when undeclared)."""
    if args.topology == "none":
        return None
    hosts = list(
        ClusterSpec.uniform(args.ranks, 2, prefix=f"h{j}").hosts
    )
    if args.topology == "shared" and faulted:
        # the faulted rank of every faulted job sits on ONE shared host:
        # the injected common cause the incident tier must promote
        hosts[hidden_fault_rank(j, args.ranks)] = SHARED_HOST
    if args.topology != "fabric":
        return ClusterSpec(world_size=args.ranks, hosts=tuple(hosts))
    # fabric: private switch+pod per host, then the shared uplink over
    # the faulted rank's (still private) host — no host is shared, so
    # the narrowest explaining tier is the switch.
    switches = [f"{h}.sw" for h in hosts]
    pods = [f"{h}.pod" for h in hosts]
    if faulted:
        # the switch is a HOST attribute: every rank of the faulted
        # rank's host must agree, else last-writer-wins re-homes the
        # host back onto its private uplink
        fault_host = hosts[hidden_fault_rank(j, args.ranks)]
        for r, h in enumerate(hosts):
            if h == fault_host:
                switches[r] = SHARED_SWITCH
                pods[r] = SHARED_POD
    return ClusterSpec(
        world_size=args.ranks, hosts=tuple(hosts),
        switches=tuple(switches), pods=tuple(pods),
    )


def _build_jobs(args) -> list[dict]:
    """Heterogeneous fleet: sync profile and fault family vary per job."""
    jobs = []
    steps = args.window * args.rounds
    profiles = list(SYNC_PROFILES.items())
    for j in range(args.jobs):
        profile_name, sync = profiles[j % len(profiles)]
        faulted = args.fault_every > 0 and j % args.fault_every == 0
        family = E3_FAMILIES[j % len(E3_FAMILIES)]
        if args.topology in ("shared", "fabric") and faulted:
            # a shared-node fault surfaces in the same stage in every
            # sharing job: pin the family (data.next_wait, non-sync in
            # every profile) so the common cause is promotable
            family = "data"
        cluster = _cluster_for(args, j, faulted)
        if faulted:
            sc = hidden_rank_scenario(
                family, world_size=args.ranks, steps=steps, seed=j,
                delay_ms=args.delay_ms, sync=sync,
            )
        else:
            sc = ddp_scenario(
                world_size=args.ranks, steps=steps, seed=j, sync=sync
            )
        if cluster is not None:
            sc = dataclasses.replace(sc, cluster=cluster)
        jobs.append({
            "job_id": f"job-{j:03d}-{profile_name}",
            "scenario": sc,
            "result": simulate(sc),
            "faulted": faulted,
            "family": family if faulted else "",
            "aggregator": WindowAggregator(sc.schema(), window_steps=args.window),
            # failure drama: job 1 dies after round 0; job 2's gather degrades
            "dies_after_round": 0 if j == 1 else None,
            "gather_degrades": j == 2,
        })
    return jobs


def run(args) -> dict:
    device = getattr(args, "device", "cuda")
    engine = (
        IncidentEngine(device=device) if args.topology != "none" else None
    )
    controller = (
        EscalationController(budget_per_tick=args.budget)
        if engine is not None
        else None
    )
    obs_on = getattr(args, "obs", True)
    if args.shards:
        service = ShardedFleetService(
            shards=args.shards, workers=args.shard_workers,
            window_capacity=args.window, evict_after=2, degrade_after=2,
            regime_windows=args.max_windows or 4,
            incidents=engine,
            device=device,
            obs=obs_on,
        )
    else:
        service = FleetService(
            window_capacity=args.window, evict_after=2, degrade_after=2,
            regime_windows=args.max_windows or 4,
            incidents=engine,
            device=device,
            obs=obs_on,
        )
    jobs = _build_jobs(args)
    packets_sent = 0
    bytes_sent = 0
    t0 = time.perf_counter()
    routes = []
    actions = []
    for w in range(args.rounds):
        batch: list[tuple[str, bytes]] = []
        for job in jobs:
            if job["dies_after_round"] is not None and w > job["dies_after_round"]:
                continue  # job stopped reporting: eviction path
            block = job["result"].durations[w * args.window:(w + 1) * args.window]
            gather_ok = not (job["gather_degrades"] and w >= 1)
            present = (
                tuple(r for r in range(args.ranks) if r != args.ranks - 1)
                if not gather_ok else tuple(range(args.ranks))
            )
            report = None
            for t in range(block.shape[0]):
                report = job["aggregator"].add_step(
                    block[t], block[t].sum(-1),
                    gather_ok=gather_ok, present_ranks=present,
                ) or report
            if report is None:
                continue
            pkt = from_diagnosis(
                report.diagnosis,
                job["scenario"].stages,
                report.steps,
                args.ranks,
                report.window_index,
                window=report.durations,
                present_ranks=present,
                sync_stages=job["scenario"].sync_stages,
                first_step=w * args.window,
                hosts=job["scenario"].hosts,
                switches=job["scenario"].switches,
                pods=job["scenario"].pods,
            )
            wire = encode_packet(pkt, compress=args.compress, wire=args.wire)
            batch.append((job["job_id"], wire))
            packets_sent += 1
            bytes_sent += len(wire)
        # one amortized decode+fold+kernel pass per aggregation round
        service.submit_many(batch, refresh=True)
        service.tick()
        routes = service.route(args.top_k)
        if controller is not None:
            actions.extend(
                controller.plan(service.current_tick, engine.incidents())
            )
    elapsed = time.perf_counter() - t0
    if args.shards:
        service.close()

    snapshot = service.snapshot()
    # the self-observability section is top-level in the summary (the
    # operator-facing "is the monitor itself slow" view), not buried
    # inside the snapshot
    obs_out = snapshot.pop("obs", None)
    out = {
        "jobs": args.jobs,
        "rounds": args.rounds,
        "shards": args.shards or 0,
        "wire": args.wire,
        "compress": args.compress,
        "packets_sent": packets_sent,
        "wire_bytes": bytes_sent,
        "wire_bytes_per_packet": bytes_sent // max(packets_sent, 1),
        "ingest_jobs_per_second": packets_sent / max(elapsed, 1e-9),
        "snapshot": snapshot,
        "routing": [
            {
                "job": r.job_id,
                "stage": r.stage,
                "rank": r.rank,
                "recoverable_s": round(r.recoverable_s, 4),
                "score": round(r.score, 4),
                "regime": r.regime,
                "persistence": round(r.persistence, 3),
                "onset_step": r.onset_step,
                "urgency": round(r.urgency, 3),
                "labels": list(r.labels),
            }
            for r in routes
        ],
    }
    if obs_out is not None:
        out["obs"] = obs_out
    if engine is not None:
        # durable incident view: identity + lifecycle over the same
        # evidence the stateless routing table above re-derives per tick
        out["incidents"] = engine.table()
        out["escalations"] = [
            {
                "tick": a.tick,
                "incident": a.incident_id,
                "jobs": list(a.jobs),
                "host": a.host,
                "stage": a.stage,
                "score": round(a.score, 4),
            }
            for a in actions
        ]
    return out


def main() -> None:
    args = make_argparser().parse_args()
    print(json.dumps(run(args), indent=2))


if __name__ == "__main__":
    main()
