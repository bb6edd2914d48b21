"""Trace-driven fleet replay driver.

    PYTHONPATH=src python -m repro_torch.launch.replay --trace cluster.jsonl --wire sfp2
    PYTHONPATH=src python -m repro_torch.launch.replay --synth --jobs 12 --ticks 16
    PYTHONPATH=src python -m repro_torch.launch.replay --synth --tick-path four-dispatch --device cpu

Loads a JSONL cluster trace (or generates the deterministic synthetic
one, `--synth`) and replays it through the fleet aggregation service:
each trace tick, every live job's window is simulated with the trace's
injected faults, aggregated, wire-encoded, and driven through the same
submit_many -> refresh -> tick -> route path as `serve_fleet`.  Prints
the machine-readable replay report (`replay.ReplayReport`):
replay volume, elastic-churn counters, per-family routing accuracy
against the trace's injected ground truth, loader skip statistics, and
the final service snapshot.

`--tick-path` picks the kernel route of every refresh: the fused tick
kernel or the four-dispatch reference (the frontier and what-if kernels,
launched separately); the two reports are identical outside wall-clock
fields.  The kernels run on `--device cuda` (the default; raises without
a GPU) or as their plain torch versions with `--device cpu`.  `--shards N`
replays through an N-shard `ShardedFleetService` (one CUDA stream per
shard); its report equals the unsharded one outside wall-clock fields.

`--save-trace PATH` additionally writes the generated synthetic trace
to disk (a convenient way to produce a trace file to inspect or to
corrupt for fuzzing); `--out PATH` writes the report JSON to a file as
well as stdout.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..replay import generate_trace, load_trace, parse_trace, replay_trace


def make_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--trace", default="",
                     help="JSONL trace file to replay")
    src.add_argument("--synth", action="store_true",
                     help="generate + replay the deterministic synthetic "
                          "trace (see --jobs/--ticks/...)")
    p.add_argument("--wire", default="sfp2", choices=["sfp1", "sfp2"])
    p.add_argument("--compress", default="int8",
                   choices=["none", "int8", "int8.delta"])
    p.add_argument("--top-k", type=int, default=2)
    p.add_argument("--evict-after", type=int, default=3)
    p.add_argument("--incidents", action="store_true",
                   help="attach the durable incident tier during replay")
    p.add_argument("--tick-path", default="fused",
                   choices=["fused", "four-dispatch"],
                   help="kernel refresh route: the fused megakernel or "
                        "the four-dispatch reference (bit-identical; "
                        "four-dispatch is the triage fallback)")
    p.add_argument("--shards", type=int, default=None,
                   help="replay through an N-shard ShardedFleetService "
                        "(stable job-id hash partition, one CUDA stream "
                        "per shard; the report is bit-identical to the "
                        "unsharded replay outside wall-clock fields)")
    p.add_argument("--shard-workers", default="thread",
                   choices=["thread", "inline"],
                   help="per-shard lanes under --shards (thread = "
                        "overlapped decode/dispatch, inline = "
                        "sequential reference)")
    p.add_argument("--obs", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="self-observability (obs) on the replay "
                        "service: the report gains an 'obs' section "
                        "(tick-phase frontier + slowest-shard "
                        "attribution, metrics, flight-recorder stats — "
                        "docs/observability.md).  On by default; "
                        "--no-obs is the overhead-benchmark control arm")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels run: 'cuda' (the hand-written "
                        "kernels; raises without a GPU) or 'cpu' (their "
                        "plain torch versions)")
    # synthetic-trace shape (ignored with --trace)
    p.add_argument("--jobs", type=int, default=12)
    p.add_argument("--ticks", type=int, default=16)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--ranks", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--delay-ms", type=float, default=150.0)
    p.add_argument("--fault-every", type=int, default=3,
                   help="every K-th job gets an injected fault (0 = none)")
    p.add_argument("--fabric", action="store_true",
                   help="with --synth: emit per-rank switch/pod fabric "
                        "placement on every arrive/resize row (ships as "
                        "SFP2-v3 topology sections)")
    p.add_argument("--shared-switch", action="store_true",
                   help="with --synth: tier-attribution trace — the "
                        "faulted ranks land on distinct hosts under ONE "
                        "shared switch with concurrent data stalls "
                        "(implies --fabric; pair with --incidents to see "
                        "the switch-tier fleet incident)")
    p.add_argument("--save-trace", default="",
                   help="with --synth: also write the generated trace here")
    p.add_argument("--out", default="",
                   help="also write the report JSON to this path")
    return p


def run(args) -> dict:
    if args.trace:
        trace = load_trace(args.trace)
    else:
        text = generate_trace(
            jobs=args.jobs, ticks=args.ticks, window_steps=args.window,
            world_size=args.ranks, seed=args.seed, delay_ms=args.delay_ms,
            fault_every=args.fault_every, fabric=args.fabric,
            shared_switch=args.shared_switch,
        )
        if args.save_trace:
            with open(args.save_trace, "w") as f:
                f.write(text)
        trace = parse_trace(text, name=f"synth-{args.seed}")
    report = replay_trace(
        trace, wire=args.wire, compress=args.compress, top_k=args.top_k,
        evict_after=args.evict_after, incidents=args.incidents,
        fused=args.tick_path == "fused",
        shards=args.shards, shard_workers=args.shard_workers,
        obs=args.obs, device=args.device,
    )
    out = report.as_dict()
    out["wire"] = args.wire
    out["compress"] = args.compress
    out["tick_path"] = args.tick_path
    out["shards"] = args.shards or 0
    return out


def main() -> None:
    args = make_argparser().parse_args()
    out = run(args)
    text = json.dumps(out, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    # a trace whose rows ALL failed to parse is an operator error even
    # though per-row damage is tolerated: exit non-zero so scripts notice
    if out["loader"]["rows"] and not out["loader"]["accepted"]:
        sys.exit(3)


if __name__ == "__main__":
    main()
