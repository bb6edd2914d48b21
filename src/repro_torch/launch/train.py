"""End-to-end training driver with always-on StageFrontier monitoring.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch paper-gpt-125m --steps 200 --batch 8 --seq 512 \
        --ckpt-dir /tmp/ckpt --resume auto --window 50

Runs on CUDA unless ``--device cpu``; without a card it raises.
Fused-step taxonomy: data.next_wait / step.dispatch / step.device_wait /
callbacks / ckpt / residual.  The monitor gathers windows, labels them,
emits evidence packets, and the policy can arm a ten-step
`torch.profiler` trace written to ``--profile-dir`` as a Chrome trace
(the paper's router-to-profiler loop), and beside it the traced steps'
device-timed regions (`telemetry.regions`) as ``regions_step<N>.json``:
each interval's region, phase, host start on the trace's clock
(``time.time_ns``) and device ms, so an idle gap on the trace can be put
down to the region the host was enqueuing.  Checkpoint/restart: ``--resume
auto`` restarts from the newest valid manifest, including the
data-pipeline cursor.

Each step's loss is copied to pinned host memory behind the step's
kernels, with an event recorded after the copy; the next step's
device-wait stage waits on that event and reads the value, so only the
previous step's device time becomes visible there while this step's
work proceeds.  The same event is the device-events handle.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..checkpoint.ckpt import restore_checkpoint, save_checkpoint
from ..configs import get_config
from ..core.contract import fused_schema
from ..data.pipeline import PrefetchPipeline, SyntheticTokens
from ..distributed.policy import Action
from ..distributed.sharding import BASELINE_PLAN
from ..models import build_model
from ..optim.adamw import AdamWConfig
from ..telemetry.collector import Monitor
from .mesh import make_local_mesh
from .steps import build_train_step, init_train_state, shard_train_state


def make_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="paper-gpt-125m")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--reduced", action="store_true", help="smoke-scale config")
    p.add_argument("--window", type=int, default=50)
    p.add_argument("--event-q", type=float, default=0.05)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--resume", default="no", choices=["no", "auto"])
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--profile-dir", default="", help="arm router-triggered traces")
    p.add_argument("--data-stall-ms", type=float, default=0.0,
                   help="inject a data-pipeline stall every 10 steps (demo)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs without a card")
    return p


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host staging that never waits for the device: through pinned
    memory with a non-blocking copy on CUDA."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _HostLoss:
    """A step's loss on its way to the host."""

    def __init__(self, loss: torch.Tensor):
        self.event = None
        if loss.is_cuda:
            self.host = torch.empty((), dtype=loss.dtype, pin_memory=True)
            self.host.copy_(loss, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = loss

    @property
    def handle(self):
        """The device-events handle: the event (a CPU loss reads ready)."""
        return self.host if self.event is None else self.event

    def value(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return float(self.host)


def run(args) -> dict:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.launch.train: CUDA was asked for but is not "
            "available (pass --device cpu to train on the CPU)"
        )
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(
        cfg,
        attn_q_chunk=min(cfg.attn_q_chunk, args.seq),
        attn_kv_chunk=min(cfg.attn_kv_chunk, args.seq),
        ssm_chunk=min(cfg.ssm_chunk, args.seq),
    )
    model = build_model(cfg)
    schema = fused_schema(world_size=1)

    profile_state = {"prof": None, "active_until": -1}

    def on_action(action: Action) -> None:
        print(f"[policy] {action.kind}: {action.reason}")
        if (action.kind == "trigger_profiler" and args.profile_dir
                and profile_state["prof"] is None):
            os.makedirs(args.profile_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            monitor.regions.log = []  # the traced steps' regions, as they fold
            profile_state.update(prof=prof, active_until=step_counter["i"] + 10)

    def stop_profile() -> str:
        prof = profile_state["prof"]
        prof.stop()
        path = os.path.join(args.profile_dir, f"trace_step{step_counter['i']}.json")
        prof.export_chrome_trace(path)
        monitor.regions.settle()
        with open(os.path.join(args.profile_dir, f"regions_step{step_counter['i']}.json"),
                  "w") as f:
            json.dump({"clock": "time.time_ns", "steps": monitor.regions.log}, f)
        monitor.regions.log = None
        profile_state.update(prof=None, active_until=-1)
        return path

    monitor = Monitor(
        schema,
        window_steps=args.window,
        event_q=args.event_q,
        on_action=on_action,
    )

    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=max(10, args.steps // 20),
                          decay_steps=args.steps)
    mesh = make_local_mesh(device=device)
    train_step, state_sh = build_train_step(
        model, mesh, BASELINE_PLAN, opt_cfg, accum_steps=args.accum
    )
    state = shard_train_state(
        init_train_state(model, torch.Generator().manual_seed(0), device), state_sh
    )

    start = 0
    if args.resume == "auto" and args.ckpt_dir:
        restored = restore_checkpoint(args.ckpt_dir, state.tree())
        if restored is not None:
            tree, extra, start = restored
            state.load(tree)
            print(f"[ckpt] resumed from step {start}")

    stall = None
    if args.data_stall_ms > 0:
        stall = lambda s: (args.data_stall_ms / 1e3) if s % 10 == 0 else 0.0
    source = SyntheticTokens(cfg.vocab_size, args.batch, args.seq, seed=1)
    pipeline = PrefetchPipeline(source, start_cursor=start, stall=stall)

    losses = []
    step_counter = {"i": start}
    prev_loss = None
    t_train0 = time.perf_counter()
    try:
        for i in range(start, args.steps):
            step_counter["i"] = i
            with monitor.step():
                with monitor.stage("data.next_wait"):
                    # host staging is part of the data path: charged here
                    host_batch = next(pipeline)
                    batch = {k: _to_device(v, device) for k, v in host_batch.items()}
                t_dispatch = time.perf_counter()
                with monitor.stage("step.dispatch_cpu_wall"):
                    state, metrics = train_step(state, batch)
                    loss = _HostLoss(metrics["loss"])
                monitor.observe_output(
                    loss.handle, (time.perf_counter() - t_dispatch) * 1e3
                )
                with monitor.stage("step.device_wait_cpu_wall"):
                    # read the PREVIOUS step's loss: this is where device
                    # time becomes host-visible (sync displacement lands
                    # here) while this step's work proceeds async.
                    if prev_loss is not None:
                        losses.append(prev_loss.value())
                    prev_loss = loss
                with monitor.stage("callbacks.cpu_wall"):
                    if i % args.log_every == 0 and losses:
                        print(f"step {i}: loss {losses[-1]:.4f}")
                with monitor.stage("ckpt.cpu_wall"):
                    if args.ckpt_dir and i and i % args.ckpt_every == 0:
                        save_checkpoint(
                            args.ckpt_dir,
                            i,
                            state.tree(),
                            extra={"data": pipeline.state()},
                        )
            monitor.end_of_step()
            if profile_state["active_until"] == i:
                print(f"[policy] heavy trace captured to {stop_profile()}")
        if prev_loss is not None:
            losses.append(prev_loss.value())
    finally:
        pipeline.close()
        if profile_state["prof"] is not None:
            stop_profile()
    train_seconds = time.perf_counter() - t_train0
    if args.ckpt_dir:
        save_checkpoint(
            args.ckpt_dir, args.steps, state.tree(),
            extra={"data": pipeline.state()},
        )

    reports = monitor.aggregator.reports
    summary = {
        "arch": cfg.name,
        "steps": args.steps - start,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "train_seconds": train_seconds,
        "monitor_overhead": monitor.overhead_fraction(train_seconds),
        "windows": [
            {
                "index": r.window_index,
                "labels": list(r.diagnosis.labels),
                "routing": list(r.diagnosis.routing_stages),
                "shares": [round(s, 4) for s in r.diagnosis.shares],
            }
            for r in reports
        ],
        "actions": [dataclasses.asdict(a) for a in monitor.actions],
    }
    return summary


def main() -> None:
    args = make_argparser().parse_args()
    summary = run(args)
    print(json.dumps(summary, indent=2, default=str))


if __name__ == "__main__":
    main()
