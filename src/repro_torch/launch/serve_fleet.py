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

`--device cuda` (the default) runs the tick kernel on the GPU and raises
where there is none; `--device cpu` runs its plain torch version.  Only
`--topology none` is offered: the incident tier and the sharded service
are not part of this package yet.  `--max-windows` bounds each job's
retained temporal history (memory knob for very long runs).
"""
from __future__ import annotations

import argparse
import json
import time

from ..core import WindowAggregator
from ..fleet import FleetService
from ..sim import simulate
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
    p.add_argument("--topology", default="none", choices=["none"],
                   help="per-job host placement and the incident tier; "
                        "only 'none' is offered in this package so far")
    p.add_argument("--max-windows", type=int, default=None,
                   help="bound per-job temporal history: the registry "
                        "retains at most this many windows of regime "
                        "state per job (pass-through to FleetRegistry "
                        "regime_windows; default 4).  The knob that "
                        "bounds memory on very long runs")
    p.add_argument("--obs", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="self-observability (obs): tick-phase "
                        "frontier over the service's own pipeline, "
                        "metrics registry, flight recorder — surfaced "
                        "as a top-level 'obs' section in the JSON "
                        "summary.  On by default; --no-obs turns it off")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tick kernel runs: 'cuda' (the "
                        "hand-written kernel; raises without a GPU) or "
                        "'cpu' (its plain torch version)")
    return p


def _build_jobs(args) -> list[dict]:
    """Heterogeneous fleet: sync profile and fault family vary per job."""
    jobs = []
    steps = args.window * args.rounds
    profiles = list(SYNC_PROFILES.items())
    for j in range(args.jobs):
        profile_name, sync = profiles[j % len(profiles)]
        faulted = args.fault_every > 0 and j % args.fault_every == 0
        family = E3_FAMILIES[j % len(E3_FAMILIES)]
        if faulted:
            sc = hidden_rank_scenario(
                family, world_size=args.ranks, steps=steps, seed=j,
                delay_ms=args.delay_ms, sync=sync,
            )
        else:
            sc = ddp_scenario(
                world_size=args.ranks, steps=steps, seed=j, sync=sync
            )
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
    if getattr(args, "topology", "none") != "none":
        raise NotImplementedError(
            "--topology other than 'none' needs the incident tier, which "
            "comes with slice 2 of the port"
        )
    if getattr(args, "shards", None):
        raise NotImplementedError(
            "--shards needs the sharded fleet service, which comes with "
            "slice 3 of the port"
        )
    service = FleetService(
        window_capacity=args.window, evict_after=2, degrade_after=2,
        regime_windows=args.max_windows or 4,
        device=getattr(args, "device", "cuda"),
        obs=getattr(args, "obs", True),
    )
    jobs = _build_jobs(args)
    packets_sent = 0
    bytes_sent = 0
    t0 = time.perf_counter()
    routes = []
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
    elapsed = time.perf_counter() - t0

    snapshot = service.snapshot()
    # the self-observability section is top-level in the summary (the
    # operator-facing "is the monitor itself slow" view), not buried
    # inside the snapshot
    obs_out = snapshot.pop("obs", None)
    out = {
        "jobs": args.jobs,
        "rounds": args.rounds,
        "shards": 0,  # the single-process service
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
    return out


def main() -> None:
    args = make_argparser().parse_args()
    print(json.dumps(run(args), indent=2))


if __name__ == "__main__":
    main()
