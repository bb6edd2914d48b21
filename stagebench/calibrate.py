"""The readings a cell's limits are set from (not part of a benchmark run).

    python3 stagebench/calibrate.py --workload <cell> --seeds 1,2,... \
        --fault-seeds 1,2,3 --control-seeds 1,2,3 --out <file.json>

On the card, at the cell's own sizes, in one process:

- *the program*: on each seed, the cell's checked steps through the
  timed loop (`loop.TrainLoop`, the monitor on), its readings against
  the reference's: the lower reading of each number is the largest of
  these;
- *half the batch left out* (a fault planted in the program: each step
  gets the first half of its rows, so the loss is the mean over them);
- *a window report altered where it is produced* (faults planted in
  the monitor: 1 ms added to the first stage of each window's first
  step as the aggregator closes it; the next stage added to each
  window's routing set as the labeler builds it);
- *the control*: the reference computed with fp8 products
  (`reference.precision`) in the program's place.

A state left unchanged reads 1 on ``grad_gap`` and ``change_gap`` by
their definition and needs no run.  The result, each variant's numbers
by seed, goes to ``--out`` as JSON.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    for _path in (CHECKOUT / "src", CHECKOUT):
        sys.path.insert(0, str(_path))


class _HalfRows:
    """A token stream whose batches keep their first half of rows."""

    def __init__(self, stream):
        self.stream, self.seed = stream, stream.seed

    def batch_at(self, cursor):
        batch = self.stream.batch_at(cursor)
        rows = batch["tokens"].shape[0] // 2
        return {k: v[:rows].copy() for k, v in batch.items()}


def _program_readings(program, stream, seed, settings, device, *, alter=None):
    """(the program's readings over the checked steps, its window
    numbers); `alter`: None, ``"report"`` or ``"routing"``."""
    import torch
    from repro_torch.core import labeler, windows
    from repro_torch.core.routing import RoutingSet
    from repro_torch.core.contract import fused_schema
    from repro_torch.data.pipeline import PrefetchPipeline
    from repro_torch.telemetry.collector import Monitor

    from stagebench.check import window_numbers
    from stagebench.loop import STAGES, TrainLoop
    from stagebench.reference.frontier import window_accounting

    checked, w = settings["check_steps"], settings["window_steps"]
    state = program.load(seed)
    monitor = Monitor(fused_schema(world_size=1), window_steps=w)
    close, candidates = windows.close_residual, labeler.candidate_set
    if alter == "report":
        def altered(d, wall, schema):
            d = d.copy()
            d[0, 0, 0] += 1e-3
            return close(d, wall, schema)
        windows.close_residual = altered
    elif alter == "routing":
        def widened(scores, tau=0.8):
            rs = candidates(scores, tau)
            extra = next(i for i in range(len(scores)) if i not in rs.stages)
            return RoutingSet(rs.stages + (extra,), rs.scores, rs.tau)
        labeler.candidate_set = widened
    pipeline = PrefetchPipeline(stream, prefetch=2)
    loop = TrainLoop(program.step, state, monitor, pipeline, device)
    out = {}
    try:
        start = program.snapshot()
        for i in range(max(checked, w)):
            loop.step()
            if i == 0:
                out["first_grad"] = program.first_grad(loop.state)
            if i == checked - 1:
                out["change"] = program.change(start)
                del start
        loop.drain()
    finally:
        pipeline.close()
        windows.close_residual, labeler.candidate_set = close, candidates
    out["losses"] = loop.losses[:checked]
    reports = [{"index": r.window_index, "shares": list(r.diagnosis.shares),
                "routing": list(r.diagnosis.routing_stages)}
               for r in monitor.aggregator.reports]
    rows = [(r.durations, r.wall) for r in monitor.recorder.history]
    win = window_numbers(reports, window_accounting(rows, STAGES + ("step.other_cpu_wall",), w))
    del loop, state
    torch.cuda.synchronize()
    return out, win


def main(argv=None) -> int:
    import argparse

    import torch

    from stagebench import spec
    from stagebench.check import train_numbers
    from stagebench.program import Program
    from stagebench.reference.train import train_readings
    from stagebench.traffic import TokenStream

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--routing-seeds", default="",
                   help="seeds of the altered routing fault alone (no reference run)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [int(s) for s in args.fault_seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    routing = [int(s) for s in args.routing_seeds.split(",") if s]
    with open(CHECKOUT / "BENCHMARK.json") as f:
        cell = spec.load_cell(args.workload, json.load(f))
    device = torch.device("cuda:0")
    config, traffic, settings = cell.config, cell.traffic, cell.settings
    t0 = time.perf_counter()
    program = Program(config, traffic, device)
    streams = {s: TokenStream(config["model"]["vocab_size"], traffic, s)
               for s in set(seeds) | set(faults) | set(controls) | set(routing)}
    prog, half, altered = {}, {}, {}
    widened = {s: _program_readings(program, streams[s], s, settings, device, alter="routing")[1]
               for s in routing}
    for s in seeds:
        prog[s] = _program_readings(program, streams[s], s, settings, device)
    for s in faults:
        half[s] = _program_readings(program, _HalfRows(streams[s]), s, settings, device)
        altered[s] = _program_readings(program, streams[s], s, settings, device, alter="report")
    t_prog = time.perf_counter() - t0
    del program
    gc.collect()
    torch.cuda.empty_cache()
    result = {"cell": cell.name, "device": torch.cuda.get_device_name(device),
              "program_s": t_prog, "seeds": {}, "altered_routing": widened}
    for s in sorted(set(seeds) | set(faults) | set(controls)):
        batches = [streams[s].batch_at(i) for i in range(settings["check_steps"])]
        t = time.perf_counter()
        ref = train_readings(config, s, batches, device)
        row = {"reference_s": time.perf_counter() - t,
               "reference_losses": ref["losses"]}
        if s in prog:
            row["program"] = dict(train_numbers(prog[s][0], ref), **prog[s][1])
            row["program_losses"] = prog[s][0]["losses"]
        if s in half:
            row["half_batch"] = dict(train_numbers(half[s][0], ref), **half[s][1])
            row["altered_report"] = dict(train_numbers(altered[s][0], ref), **altered[s][1])
        if s in controls:
            ctl = train_readings(config, s, batches, device, precision="fp8")
            row["control"] = train_numbers(ctl, ref)
        result["seeds"][s] = row
        print(json.dumps({s: row}), file=sys.stderr, flush=True)
    result["total_s"] = time.perf_counter() - t0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
