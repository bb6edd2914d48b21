#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU (sm_90a:
H100).  It drives the port (`src/repro_torch`) only — never the JAX
package — in four phases, and exits non-zero if any fails:

  build    compiles `csrc/fused_tick.cu` with nvcc from the checkout;
  kernel   runs the fused tick kernel on the card against its plain torch
           version on the same inputs (numpy seeds) at the service's own
           group shapes, the larger service shape, edge shapes and a
           fleet-scale shape: integer fields exact, float fields within
           rtol 1e-5 / atol 1e-6; times both with CUDA events (L2 flushed
           before every launch) beside the byte bound at 3.35 TB/s, and
           the whole `fused_fleet_tick` call (prolog + kernel + epilog)
           on the host clock;
  service  runs `serve_fleet` at 64 jobs x 128 ranks x 100-step windows
           for 3 rounds on the card, with the launch count reset just
           before, and checks that the kernel ran, that the top route is
           a faulted job, and that routes and snapshot equal a
           `--device cpu` run; prints the service's per-phase tick split;
  profile  the same service run under torch.profiler: device busy time
           by kernel against the service's tick time.

It prints a `kernels` JSON line, the card's name and power limit
(nvidia-smi), and last `{"ok": true, "device": {...}}`.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/kernels/frontier/csrc/fused_tick.cu"
REPLACES = "src/repro/kernels/frontier/fused.py:103"

#: H100 SXM: device memory rate and the float32 rate outside the tensor
#: cores (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: operations the kernel does per window element (two stage-prefix adds,
#: two excesses, the clip, the top-2 compares, the what-if max/sub/add
#: chain): an upper estimate, far below the byte bound either way
OPS_PER_ELEMENT = 20

#: serve_fleet's sync profiles as stage indices of the six-stage schema
DDP, FSDP, ZERO1 = (2,), (1, 2), (2, 4)
SERVICE_ARGS = ["--jobs", "64", "--ranks", "128", "--window", "100",
                "--rounds", "3"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def kernel_cases():
    """(label, shape, kwargs) of every kernel-phase call."""
    # the service at 64 jobs stacks three sync groups of 22/21/21 jobs,
    # each padded to 32: these three calls are the main path's own
    main = [
        (f"service group {name}", (32, 100, 128, 6),
         dict(sync_stages=sync, with_regimes=False))
        for name, sync in (("ddp", DDP), ("fsdp", FSDP), ("zero1", ZERO1))
    ]
    return main + [
        ("service shape", (64, 100, 128, 6),
         dict(sync_stages=DDP, with_regimes=False)),
        ("service shape, regimes+hosts", (64, 100, 128, 6),
         dict(sync_stages=DDP, with_regimes=True, hosts=64)),
        ("edge", (1, 4, 1, 4), dict(sync_stages=(1,), hosts=1)),
        ("edge", (3, 6, 129, 5), dict(sync_stages=(1, 4), hosts=7)),
        ("edge", (2, 5, 300, 6), dict(sync_stages=DDP, hosts=3)),
        ("edge, no sync", (2, 5, 300, 6), dict(sync_stages=None)),
        ("edge, 10 stages", (4, 7, 200, 10), dict(sync_stages=(3, 9), hosts=5)),
        ("fleet scale", (256, 100, 512, 8),
         dict(sync_stages=(2, 5), with_regimes=False)),
    ]


def flat_fields(acc):
    """Named tensors of a TickAccumulators (regime tuple flattened)."""
    out = []
    for name, v in zip(acc._fields, acc):
        if isinstance(v, tuple):
            out.extend((f"{name}[{i}]", t) for i, t in enumerate(v))
        else:
            out.append((name, v))
    return out


def compare(got, want, torch) -> float:
    """Ints exact, floats close; returns the largest finite abs error."""
    worst = 0.0
    for (name, g), (_, w) in zip(flat_fields(got), flat_fields(want)):
        if (g is None) != (w is None):
            raise AssertionError(f"{name}: presence differs")
        if g is None:
            continue
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=name)
            fin = torch.isfinite(w)
            if fin.any():
                worst = max(worst, (g[fin] - w[fin]).abs().max().item())
        elif not torch.equal(g, w):
            raise AssertionError(
                f"{name}: {(g != w).sum().item()} integer entries differ"
            )
    return worst


def bytes_moved(x, acc) -> int:
    """Each input read once (distinct storages: a broadcast baseline is
    its [J, S] rows), each output written once."""
    seen, total = set(), 0
    for t in (x.d, x.wmin, x.bd, x.bw, x.amax, x.second, x.leader,
              x.relprev, x.thr, x.host):
        if t is None:
            continue
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    for _, t in flat_fields(acc):
        if t is not None:
            total += t.numel() * t.element_size()
    return total


def time_ms(fn, reps: int, torch, flush) -> float:
    """Mean device time of `fn` over `reps` runs, L2 flushed first.

    A ~1 ms spin kernel goes ahead of each timed run, so the host has
    queued the run's launches before the device reaches the start event:
    a single kernel is timed without its Python wrapper; the plain
    version, whose host loop outlasts the spin, still pays its host gaps.
    """
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def wall_ms(fn, reps: int, torch) -> float:
    """Median host-clock time of `fn` to its synchronised end."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def kernel_phase(torch, np, fused):
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB
    rows = []
    for label, shape, kw in kernel_cases():
        kw = dict(kw)
        hosts = kw.pop("hosts", 0)
        rng = np.random.default_rng(sum(shape) + hosts)
        d = rng.exponential(0.03, shape).astype(np.float32)
        if hosts:
            kw["host_index"] = rng.integers(0, hosts, (shape[0], shape[2]))
            kw["num_hosts"] = hosts
        x = fused.tick_inputs(torch.from_numpy(d).cuda(), **kw)
        got = fused._fused_tick_cuda(x)
        torch.cuda.synchronize()
        want = fused._fused_tick_plain(x)
        err = compare(got, want, torch)
        pg, pw = fused._epilog(x, got), fused._epilog(x, want)
        for fam in ("frontier", "whatif", "regimes", "coact"):
            a, b = getattr(pg, fam), getattr(pw, fam)
            if a is None:
                continue
            for name, u, v in zip(a._fields, a, b):
                if u.dtype.is_floating_point:
                    torch.testing.assert_close(
                        u, v, rtol=1e-5, atol=1e-6, msg=f"{fam}.{name}"
                    )
                elif not torch.equal(u, v):
                    raise AssertionError(f"{fam}.{name} differs")
        ms = time_ms(lambda: fused._fused_tick_cuda(x), 20, torch, flush)
        plain_ms = time_ms(lambda: fused._fused_tick_plain(x), 3, torch, flush)
        # the whole public call (prolog + kernel + epilog) from a CUDA tensor
        d_cuda = x.d
        tick_ms = wall_ms(
            lambda: fused.fused_fleet_tick(d_cuda, **kw), 5, torch
        )
        nbytes = bytes_moved(x, got)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = OPS_PER_ELEMENT * x.d.numel() / F32_OPS_PER_S * 1e3
        row = dict(
            label=label, shape=list(shape),
            sync=list(kw.get("sync_stages") or ()),
            regimes=bool(kw.get("with_regimes", True)), hosts=hosts,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, tick_ms=tick_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes,
        )
        rows.append(row)
        print("kernel case " + json.dumps(row), flush=True)
    return rows


def service_phase(fused, serve_fleet):
    fused.launches = 0
    t0 = time.perf_counter()
    out = serve_fleet.run(
        serve_fleet.make_argparser().parse_args(SERVICE_ARGS + ["--device", "cuda"])
    )
    wall = time.perf_counter() - t0
    launches = fused.launches
    if launches <= 0:
        raise AssertionError("the service run launched the tick kernel 0 times")
    routes = out["routing"]
    if not routes:
        raise AssertionError("the service returned no route")
    top = int(routes[0]["job"].split("-")[1])
    if top % 3 != 0:  # serve_fleet faults every 3rd job by default
        raise AssertionError(f"top route {routes[0]['job']} is not a faulted job")
    t1 = time.perf_counter()
    ref = serve_fleet.run(
        serve_fleet.make_argparser().parse_args(SERVICE_ARGS + ["--device", "cpu"])
    )
    cpu_wall = time.perf_counter() - t1
    key = [(r["job"], r["stage"], r["rank"]) for r in routes]
    ref_key = [(r["job"], r["stage"], r["rank"]) for r in ref["routing"]]
    if key != ref_key:
        raise AssertionError(f"cuda routes {key} != cpu routes {ref_key}")
    for a, b in zip(routes, ref["routing"]):
        if abs(a["recoverable_s"] - b["recoverable_s"]) > 1e-4 * abs(b["recoverable_s"]) + 1e-4:
            raise AssertionError(f"recoverable_s {a} vs {b}")
    if out["snapshot"] != ref["snapshot"]:
        raise AssertionError("cuda and cpu snapshots differ")
    obs = out.get("obs") or {}
    hist = obs.get("metrics", {}).get("histograms", {})
    split = {
        name.split("phase_seconds.", 1)[1]: h["sum"]
        for name, h in hist.items() if name.startswith("phase_seconds.")
    }
    summary = dict(
        launches=launches, wall_s=wall, cpu_wall_s=cpu_wall,
        top_route=routes[0], routes=len(routes),
        phase_seconds=split,
        tick_frontier=obs.get("tick_frontier"),
    )
    print("service " + json.dumps(summary), flush=True)
    return launches


def profile_phase(torch, serve_fleet) -> None:
    """The service run once more under torch.profiler: device busy time
    by kernel, against the service's own tick time (obs)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = serve_fleet.run(serve_fleet.make_argparser().parse_args(
            SERVICE_ARGS + ["--device", "cuda"]
        ))
    torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    tick_s = out["obs"]["tick_frontier"]["exposed_s"]
    print("profile " + json.dumps(dict(
        device_busy_s=busy_s, service_tick_s=tick_s,
        device_busy_share_of_tick=busy_s / tick_s if tick_s else None,
        top=[dict(name=k[:80], device_us=us, count=c) for us, k, c in rows[:8]],
    )), flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isfile(os.path.join(src, "repro_torch", "__init__.py")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, src)
    from repro_torch.kernels.frontier import _lib, fused
    from repro_torch.launch import serve_fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = _lib.build("fused_tick.cu")
    print(f"build {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas " + line.strip(), flush=True)

    rows = kernel_phase(torch, np, fused)
    launches = service_phase(fused, serve_fleet)
    profile_phase(torch, serve_fleet)

    main_row = rows[0]  # the service's own DDP group shape
    print(json.dumps({"kernels": [{
        "name": "fused_tick",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
