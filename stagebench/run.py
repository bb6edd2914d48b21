"""One run of a benchmark cell: set-up, a measured window, the check.

    python3 stagebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run builds the program (the
`repro_torch` train step under its `Monitor`), draws the weights and
the token stream from ``--seed``, takes the cell's warm-up steps through
the timed loop (`loop.TrainLoop`) and reads from them what the check
compares, then measures ``--seconds`` of steps.  With ``--trace 1`` the
window runs under `torch.profiler` and the line carries the cell's
per-layer metrics and a breakdown; with ``--trace 0`` its end-to-end
metrics.  After the window the program's state is freed and the plain
reference (`stagebench.reference`) takes the same first steps; the
numbers compared and their limits end standard error and the result's
line.

Exit codes: 0 with a result line; 2 without the cell's cards; 3 when
the program cannot be imported (a directory without ``src/``) or JAX,
flax or the JAX package were loaded.  Every cache of the program
lives under ``build/`` of the checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

_START = time.perf_counter()
CHECKOUT = Path(__file__).resolve().parent.parent

#: top-level module names the run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_STARTED = _START - _process_age()

if __name__ == "__main__":
    for _path in (CHECKOUT / "src", CHECKOUT):
        sys.path.insert(0, str(_path))
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell, bench: dict, seed: int, seconds: float, trace: bool, device,
             *, started: float = _STARTED, root=None) -> dict:
    """Run `cell` (`spec.Cell`) once; returns the result line's object
    (its ``checks`` last), or raises."""
    import torch

    from repro_torch.core.contract import fused_schema
    from repro_torch.data.pipeline import PrefetchPipeline
    from repro_torch.telemetry.collector import Monitor

    from . import spec
    from .check import judge, train_numbers, window_numbers
    from .flops import step_flops
    from .loop import STAGES, TrainLoop
    from .program import Program
    from .record import RunRecord
    from .reference.frontier import window_accounting
    from .reference.train import train_readings
    from .trace import WINDOW, reduce_events
    from .traffic import TokenStream, stall_of

    root = spec.HERE if root is None else root
    device = torch.device(device)
    cuda = device.type == "cuda"
    config, traffic, settings = cell.config, cell.traffic, cell.settings
    checked = settings["check_steps"]
    window_steps = settings["window_steps"]
    # warm-up takes the checked steps and closes the monitor's first
    # window, whose first labelling loads what it needs once
    warmup = max(settings["warmup_steps"], checked, window_steps)

    program = Program(config, traffic, device)
    state = program.load(seed)
    stream = TokenStream(config["model"]["vocab_size"], traffic, seed)
    pipeline = PrefetchPipeline(stream, prefetch=traffic["prefetch"], stall=stall_of(traffic))
    monitor = Monitor(fused_schema(world_size=1), window_steps=window_steps)
    loop = TrainLoop(program.step, state, monitor, pipeline, device, spans=trace)
    prof = None
    try:
        # warm-up: the first steps are the checked ones
        start = program.snapshot()
        prog = {}
        for i in range(warmup):
            loop.step()
            if i == 0:
                prog["first_grad"] = program.first_grad(loop.state)
            if i == checked - 1:
                prog["change"] = program.change(start)
                del start
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        window = contextlib.nullcontext()
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=activities)
            prof.start()
            window = record_function(WINDOW)
        first, path0 = loop.steps, monitor.monitor_path_seconds
        t0 = time.perf_counter()
        with window:
            while time.perf_counter() - t0 < seconds:
                loop.step()
            loop.drain()
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
    finally:
        pipeline.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loaded = forbidden_modules()
    if loaded:
        raise ImportError(f"loaded during the run: {', '.join(loaded)}")

    steps = loop.steps - first
    history = monitor.recorder.history
    record = RunRecord(
        cell=cell.name, config=config, traffic=traffic, steps=steps,
        tokens_per_step=traffic["batch"] * traffic["seq"], window_s=t1 - t0,
        setup_s=t0 - started, peak_bytes=peak, step_records=list(history[first:]),
        monitor_seconds=monitor.monitor_path_seconds - path0,
        monitor_windows=loop.steps // window_steps - first // window_steps,
        flops_per_step=step_flops(config, traffic["batch"], traffic["seq"]),
        peak_flops=_peak(root, torch.cuda.get_device_name(device) if cuda else "cpu",
                         config["model"]["compute_dtype"]),
    )
    if prof is not None:
        t_trace = time.perf_counter()
        reduced = reduce_events(prof.profiler.kineto_results.events())
        print(f"stagebench: trace read in {time.perf_counter() - t_trace:.1f} s", file=sys.stderr)
        if reduced is not None:
            record.trace = dict(reduced, steps=steps)
        del prof

    # the monitor's windows against the reference's accounting of the
    # recorder's stage vectors
    reports = [{"index": r.window_index, "shares": list(r.diagnosis.shares),
                "routing": list(r.diagnosis.routing_stages)}
               for r in monitor.aggregator.reports]
    rows = [(r.durations, r.wall) for r in history]
    stages = STAGES + ("step.other_cpu_wall",)
    numbers = window_numbers(reports, window_accounting(rows, stages, window_steps))
    prog["losses"] = loop.losses[:checked]
    failed = loop.failed(first)

    # free the program before the reference runs
    del loop, state, program, monitor, history
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    batches = [stream.batch_at(i) for i in range(checked)]
    t_ref = time.perf_counter()
    ref = train_readings(config, seed, batches, device)
    print(f"stagebench: reference {time.perf_counter() - t_ref:.1f} s, window {steps} steps "
          f"in {t1 - t0:.2f} s, set-up {t0 - started:.1f} s", file=sys.stderr)
    numbers = dict(train_numbers(prog, ref), **numbers)
    correct, checks = judge(numbers, settings.get("limits", {}))
    correct = correct and failed == 0

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, cell.name, section):
        value = spec.load_reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": steps,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.settings["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if record.trace is not None:
        result["device"]["busy_s"] = record.trace["busy_s"]
        result["device"]["window_s"] = record.trace["window_s"]
        result["breakdown"] = {"device_ops": record.trace["device_ops"],
                               "idle_gaps": record.trace["idle_gaps"]}
    result["checks"] = checks
    return result


def _peak(root, kind: str, dtype: str) -> float | None:
    with open(Path(root) / "peaks.json") as f:
        return json.load(f).get(kind, {}).get(dtype)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from stagebench import run as harness
    from stagebench import spec

    with open(CHECKOUT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = spec.load_cell(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.settings["chips"]:
        print(f"stagebench: {args.workload} needs {cell.settings['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(cell, bench, args.seed, args.seconds, bool(args.trace), "cuda:0")
    except ImportError as e:
        print(f"stagebench: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
