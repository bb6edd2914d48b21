#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU (sm_90a:
H100).  It drives the port (`src/repro_torch`) only — never the JAX
package — in these phases, and exits non-zero if any fails:

  build    compiles the five CUDA sources of `csrc/` (`fused_tick.cu`,
           `coactivation.cu`, `frontier_window.cu`, `whatif_matrix.cu`,
           `regime_stats.cu`), the attention kernel's (head_dim 64,
           bf16) instance (`kernels/attention/csrc/causal_attention.cu`)
           and every instance of the SSD scan (`kernels/ssd/csrc/
           ssd_scan.cu`: (P, N) = (64, 16) hymba-1.5b, (64, 128)
           mamba2-130m, (16, 16) the reduced configs) with nvcc from the
           checkout, all at once, prints what ptxas says of their
           registers, shared memory and spills, and fails on any spill
           but those `SPILL_EXEMPT` names with their reason (mamba2's
           backward and the reduced configs' chunk kernel, each faster
           than its spill-free build);
  attention  the causal-attention kernel at the benchmark cells' shapes
           (granite-3-2b: [4, 4096, 32, 64] and [32, 512, 32, 64] bf16, 8
           KV heads): its output against the plain walk's, its dq, dk
           and dv against the plain walk's taken in f32 (the card tests'
           limits; the greatest differences in the line), then its
           forward (one launch, saving the log-sum-exp and the f32
           output) and backward (two launches) timed with CUDA events,
           L2 flushed, beside their bound (the FLOPs of one bf16 MMA for
           q.k and three for P.V an element forward, eleven backward, at
           989 TFLOP/s), the plain walk's forward and forward + backward,
           and `scaled_dot_product_attention`'s (the yardstick, never
           called by the port); an `attention` line;
  ssd      the SSD scan's kernels at hymba-1.5b's layer shape in its
           train cell (xh [4, 4096, 50, 64] and B, C [4, 4096, 16] sliced
           from one conv output, chunk 256, f32): the output and the
           gradients of all six inputs against the plain `_ssd`'s, each
           held to the plain version in f64 (the card tests' limit: at
           most 4x the plain f32 version's own error, plus 2**-20 of the
           largest value), then the forward (three launches, keeping the
           entering states) and the backward (four launches) timed with
           CUDA events, L2 flushed, beside their bound (the larger of the
           FLOPs, the chunk kernel's at 67 TFLOP/s of f32 FMA plus the
           split products' six bf16 MMA passes at 989 TFLOP/s, and the
           bytes at 3.35 TB/s) and the plain version's forward and
           forward + backward; then one train step of hymba-1.5b at full
           width cut to 2 layers, its scan launches counted from zero
           (each forward kernel 2 x layers times, the pass and the remat,
           each backward kernel once a layer); an `ssd` line;
  kernel   runs the fused tick kernel on the card against its plain torch
           version on the same inputs (numpy seeds) at the service's own
           group shapes, the larger service shape, edge shapes (one step,
           a step count no multiple of the frontier role's step chunk,
           R*S no multiple of 128 with the last stage synced, one rank,
           an explicit [R, S] baseline, R*S = 42 and 63, 32 stages, 513
           ranks, the max tied between ranks of different rank groups,
           warps and rank tiles, where the frontier kernel must also name
           the lowest tied rank), the accumulation-expanded 18/27/33-stage
           schemas, 300 stages, 2,400 and 2,500 stages (around the cell
           walk's former shared-memory limit, with regimes and hosts), a
           window fed values around FLT_MIN, and a fleet-scale shape: bit
           for bit on every field; times both with CUDA events
           (L2 flushed before every launch) beside the byte bound at 3.35
           TB/s, and the whole `fused_fleet_tick` call (prolog + kernel +
           epilog) on the host clock.  At every case it also holds the
           frontier, what-if and regime kernels (the four-dispatch route)
           against their plain versions, bit for bit, times them the same
           way, and holds `four_dispatch_tick` against `fused_fleet_tick`
           on the card, bit for bit on every field of every family;
  fabric   runs `serve_fleet --topology fabric` at 64 jobs x 128 ranks x
           100-step windows for 3 rounds on the card, with both launch
           counts reset just before, and checks that both kernels ran,
           that exactly one switch-tier fleet incident formed on the
           shared uplink, and that incidents, escalations, routes and
           snapshot equal a `--device cpu` run; prints its phase split;
  service  runs `serve_fleet` (no topology) at the same size on the card,
           with the tick's launch count reset just before, and checks
           that the kernel ran, that the top route is a faulted job, and
           that routes and snapshot equal a `--device cpu` run; prints
           the service's per-phase tick split;
  tick     drives the public `four_dispatch_tick` with every family at
           the service shape (64 jobs, 64 hosts), launch counts reset
           just before: each of its four kernels launches once, the fused
           kernel never, and the packet equals `fused_fleet_tick`'s;
  replay   runs `python -m repro_torch.launch.replay --synth --jobs 64
           --ranks 128 --window 100 --ticks 6 --incidents --shared-switch
           --tick-path four-dispatch` on the card, launch counts reset just
           before: the frontier, what-if and co-activation kernels launch,
           the fused kernel never, and one switch-tier fleet incident forms
           on the shared uplink; the same run with `--tick-path fused`
           gives the same report outside its wall-clock fields; prints
           both runs' phase split;
  shard    the sharded service on the card, one CUDA stream per shard:
           first the tick's per-job results against J (the fused and the
           four-dispatch tick of 32 jobs against the same jobs stacked 1,
           2, 4, 8 and 16 at a time, bit for bit: a shard stacks fewer
           jobs than the whole fleet); then `serve_fleet --topology fabric` at the
           fabric phase's size with `--shards 3 --shard-workers thread`
           and `--shards 8 --shard-workers inline`, each equal to the
           phase's own unsharded card run exactly and to a `--device cpu
           --shards 3` run, the one switch-tier incident formed once, the
           fused launches equal to the (shard, group) refreshes and the
           co-activation launches to the unsharded run's; and the replay
           with `--shards 3` on both tick paths, each report equal to the
           unsharded fused report outside its wall-clock fields.  Prints
           each run's wall time, phase split and the coordinator's tick
           frontier;
  coact    runs the co-activation kernel against its plain torch version
           on the card, exactly, on the fabric run's and the four-dispatch
           replay's own group tensors (each distinct shape), edge shapes
           (one job, 67 and 130 jobs, one host, one step, 37 steps, five
           stages, C*S = 111 and 1,200, all ones, all zeros, one job alone
           on a column, 800 to 2,500 steps (one or two chunks of the
           kernel's step array), tiers with unmapped hosts), many jobs
           (32,768 x 20 x 4 x 2 in 16-block clusters, 16,384 x 4 x 68 x 8
           in 8-block ones: the job array in chunks; 32,768 x 2,000 x 1 x
           2: act read twice) and a fleet-scale shape, timed as above;
  groups   the inputs the fabric, service and fused replay runs handed
           the fused kernel and the tick and four-dispatch replay runs
           handed each single-family kernel, recorded at each (shape, sync
           set, families): there each kernel is held against its plain
           version bit for bit and timed; so are the inputs the shard
           phase's sharded runs (the shards' own groups, padded to a power
           of two of jobs each) and its J case (every stack, the whole 32
           included) handed them; the `kernels` line takes the
           frontier and what-if times from the replay's largest group, the
           regime times from the tick's;
  profile  the service and fabric runs once more under torch.profiler:
           device busy time by kernel against the service's tick time;
  train    the training driver with the per-job monitor
           (`python -m repro_torch.launch.train`): paper-gpt-125m at full
           width (12 layers, d_model 768, vocab 50,304, bf16, remat),
           batch 8 x 512, 60 steps, 20-step windows: the loss falls,
           three windows each labelled `frontier_accounting` with shares
           summing to 1 +- 0.02, device events sampled and ready; prints
           the median step, tokens/s, `monitor_overhead` and peak memory,
           and the card's busy share under torch.profiler over 20 steps;
           the same run with a 50 ms data stall every 10 steps (the
           prefetch holds ~3 steps, so it hides it: printed) and with a
           stall of 10 median steps, which must route a window to
           `data.next_wait`; one train step of the same model cut to 2
           layers in f32, TF32 off, on the card against the CPU from the
           same weights (loss rtol 1e-5; 99.9 % of parameters within 1e-6,
           all within 2 x lr; the bf16 loss within 2e-2 of the f32 one);
           and `TorchDistTransport` on a one-rank NCCL group: a window
           gathered on cuda:0 unchanged, and after the group is destroyed
           a gather that raises nothing and falls back to the local parts;
  serve    the model serve driver and its decode path
           (`python -m repro_torch.launch.serve`), one JSON line a run:
           (a) paper-gpt-125m at full width and depth (12 layers, d 768,
           vocab 50,304, bf16), batch 8, a 128-token prompt fed token by
           token, 128 greedy tokens, 16-step windows: 128 decoded, the
           windows labelled, the routing non-empty; prints tokens/s, the
           median decode step, peak memory, and the card's busy share
           under torch.profiler over 32 decode steps; (b) the same model
           cut to 2 layers in f32, TF32 off: 64 teacher-forced decode
           steps in both cache layouts on the card and on the CPU from
           the same weights, logits within atol/rtol 1e-4, the two
           layouts on the card within 1e-5, the agreeing greedy tokens
           printed; (c) mamba2-130m at full width and depth, 8 x (32 +
           32), then (b) at 2 layers; (d) hymba-1.5b at full width and
           depth, 4 x (16 + 16), then its ring buffer at 2 layers in f32:
           1,040 teacher-forced steps past the 1,024-token window, card
           against CPU to 1e-4; (e) phi3.5-moe-42b-a6.6b at full width
           cut to 2 layers (its 32 need ~84 GB in bf16), 8 x (16 + 16):
           at least one decode step drops an assignment at an expert's
           capacity (counted with `moe.dropped`), then card against CPU
           at 1 layer in f32; (f) internvl2-1b at full width and depth,
           8 x (32 + 32) (the vlm family's decode); (g) whisper-base,
           the encoder-decoder family, at full width and depth (6 + 6
           layers, d 512, vocab 51,865, bf16), 8 x (128 + 128): the
           driver runs the encoder over 64 zero frames in its prefill
           stage and decodes against the cross K/V; its windows labelled
           and routed; the encoder pass and the cross-cache build timed
           apart (CUDA events), 32 decode steps profiled as (a)'s; then 2 + 2 layers in f32: 64
           teacher-forced decode steps over random frames on the card
           and on the CPU (logits within 1e-4, greedy tokens equal), and
           the forward logits and the loss (layers checkpointed) of the
           same batch within 1e-4.  Every family run must label its
           windows and route them;
  examples the five examples of the port (`repro_torch.examples`:
           hidden_rank_demo, whatif_demo, fleet_monitor, serve_demo and
           quickstart, the last at 60 steps with its checkpoints under
           build/) with `--device cuda` and their own asserts, the launch
           counts reset just before each and read just after:
           fleet_monitor launches the fused tick and the frontier kernel
           1 + 4 times, whatif_demo the what-if kernel once; each
           example's wall and launches printed; the inputs they hand the
           kernels are held against the plain versions bit for bit in
           the group phases;
  mesh     `make_local_mesh()` is one device of the card with no process
           group; the train step built on it under BASELINE_PLAN and the
           serve step under DECODE_PLAN (paper-gpt-125m at full width, 2
           layers, f32: 3 train steps, 32 decode steps) equal the plain
           steps bit for bit, every parameter, moment and cache
           included; `compress_grads` on the card equals its CPU result
           on the same leaves bit for bit; the sequence-parallel decode's
           softmax in one process (`chunked_decode_attention`, a 32k
           cache in 16 chunks, paper-gpt-125m's 12 heads of 64, filled
           to 20,000 so the last chunks are masked) equals
           `decode_attention` on the card in both cache layouts and both
           `cast_f32` values (f32 within 1e-6; bf16 within one bf16
           rounding, atol 1e-2 and rtol 2**-7); the train and prefill
           steps' splits over 16 ranks of `model`, each computed in one
           process (the scan and the causal splits run the SSD scan's and
           the attention's CUDA kernels on both sides, kernel against
           kernel; the kernels against the plain versions are held in the
           ssd and attention phases and the card tests): mamba2-130m's
           SSD at full width (2 x
           4,096) in 16 slices of d_inner, the norm's sums of squares
           summed (`ssm.split_ssm`), against `apply_ssm` within 1e-5,
           and the query split (`attention.query_split_attention`, 16
           ranks' zigzag blocks, k and v whole) of causal attention with
           whisper-base's heads (8 of 64) and llama4-scout's (40 of 128,
           8 KV) over 32,768 positions, with and without `triangular`,
           and of whisper's cross-attention (32,768 queries over 8,192
           frames), against the whole attention within 1e-6 (each case's
           error, bit-identity and seconds printed); meanwhile two Gloo
           ranks on the CPU, under this machine's own torch, run the
           phi3.5-moe train step (reduced) under BASELINE_PLAN on (2, 1),
           its experts' hidden dim stored over `data` and gathered in
           each layer, and the split scan's prefill (mamba2 reduced,
           d_inner 192 in 6 heads of 32) on (1, 2), held against the
           one-device steps (loss and grad norm within rel 1e-5, 99.9 %
           of parameter elements within 1e-6 and all within 2 x lr,
           logits within 1e-5; a `mesh-gloo` line).  The train and serve
           phases above build their steps through the same mesh and
           plans;
  dryrun   `python -m repro_torch.launch.dryrun` on a fake 256/512-rank
           group, in subprocesses, all at once: qwen1.5-0.5b train_4k (one
           microbatch), mamba2-130m decode_32k on both meshes, phi3.5-moe
           and whisper-base decode_32k, the skipped paper-gpt-125m
           long_500k, mamba2-130m prefill_32k on (16, 16) and
           whisper-base prefill_32k on (2, 16, 16) (the split scan and
           the query split), each with `--device cuda` and `--device cpu` into
           build/dryrun/: every row `ok` or `skipped`, every card row
           equal to its CPU row outside `compile_s`, `delta_s` and
           `wall_s`; one `run_cell` in this process leaves
           `torch.cuda.memory_allocated()` unchanged and no process group
           up; the qwen train row's per-device FLOPs and all-gather bytes
           (its step computes on its shards of the weights: Megatron
           tensor parallelism under BASELINE_PLAN) on a line of their
           own, and the decode rows' FLOPs, temp and all-gather bytes on
           another (each rank decodes its rows against its slices of the
           caches under DECODE_PLAN), and the prefill rows' on a
           `dryrun-split-scan` line; phi3.5-moe train_4k on (16, 16) at
           full width cut to 2 layers, four microbatches, on the card and
           on the CPU in two more subprocesses: the rows equal, its temp,
           all-gather and reduce-scatter bytes on a `dryrun-moe-train`
           line (each layer gathers its experts where it reads them);
           then the dry run of the train phase's own step
           (paper-gpt-125m, one device, 8 x 512, bf16) beside that
           phase's measured peak: its `args_bytes` must not exceed it.

It prints a `kernels` JSON line, the card's name and power limit
(nvidia-smi), and last `{"ok": true, "device": {...}}`.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.

    python3 chip_smoke.py --keep-going

measures a tree that refuses or fails some kernel or co-activation cases
(an older checkout, to time it beside this one): each such kernel
measurement prints a `failed` line with its error and the rest go on;
the script still exits non-zero and prints no result when any failed.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "src/repro_torch/kernels/frontier/csrc"
#: kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "fused_tick": ("fused_tick.cu", "src/repro/kernels/frontier/fused.py:103"),
    "coactivation": ("coactivation.cu",
                     "src/repro/kernels/frontier/incidents.py:101"),
    "frontier_window": ("frontier_window.cu",
                        "src/repro/kernels/frontier/frontier.py:72"),
    "whatif_matrix": ("whatif_matrix.cu",
                      "src/repro/kernels/frontier/frontier.py:203"),
    "regime_stats": ("regime_stats.cu",
                     "src/repro/kernels/frontier/frontier.py:281"),
}
#: the four-dispatch route's single-family kernels -> (CUDA wrapper,
#: plain version) in `kernels/frontier/frontier.py`
WRAPPERS = {
    "frontier_window": ("_frontier_cuda", "_frontier_plain"),
    "whatif_matrix": ("_whatif_cuda", "_whatif_plain"),
    "regime_stats": ("_regime_cuda", "_regime_plain"),
}
FOUR_DISPATCH = tuple(WRAPPERS)

#: H100 SXM: device memory rate and the float32 rate outside the tensor
#: cores (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: operations the kernel does per window element (two stage-prefix adds,
#: two excesses, the clip, the top-2 compares, the what-if max/sub/add
#: chain): an upper estimate, far below the byte bound either way
OPS_PER_ELEMENT = 20
#: the co-activation kernel's operations per activity byte (the test, the
#: step-sum add, the any-or), at the same rate: far below its byte bound
COACT_OPS_PER_ELEMENT = 3
#: operations per window element of the single-family kernels (upper
#: estimates): the frontier's prefix add, top-2 compares and clip; the
#: what-if's excess, arrival and max/sub/add chain; the regime fold's
#: excess, test, integer updates and two adds.  Far below the byte bound.
FAMILY_OPS_PER_ELEMENT = {
    "frontier_window": 10, "whatif_matrix": 10, "regime_stats": 12,
}

#: ranks that share the max of a tied window: in different rank groups,
#: warps and batches of the frontier kernel's warp fold at six stages, and
#: in three of its 128-rank tiles past 32 stages
TIED_RANKS = (5, 37, 69, 133, 290)

#: serve_fleet's sync profiles as stage indices of the six-stage schema
DDP, FSDP, ZERO1 = (2,), (1, 2), (2, 4)
SERVICE_ARGS = ["--jobs", "64", "--ranks", "128", "--window", "100",
                "--rounds", "3"]
FABRIC_ARGS = SERVICE_ARGS + ["--topology", "fabric"]
#: the replay driver at the service's width: 64 jobs x 128 ranks x
#: 100-step windows, the faulted ranks under one shared switch
REPLAY_ARGS = ["--synth", "--jobs", "64", "--ranks", "128", "--window", "100",
               "--ticks", "6", "--incidents", "--shared-switch"]
#: report fields that carry wall-clock state, and the route's own name
REPLAY_VOLATILE = ("elapsed_s", "windows_per_s", "obs", "tick_path")
#: the shared uplink of `serve_fleet --topology fabric`
FABRIC_SWITCH = "fab-sw0"
#: the shard phase's sharded fabric runs: (shards, worker lanes)
SHARD_RUNS = ((3, "thread"), (8, "inline"))
#: the stack of jobs whose tick the shard phase holds against sub-stacks
J_INVARIANCE_SHAPE = (32, 100, 128, 6)
#: the sub-stacks: every power of two a shard's group pads to below 32
J_INVARIANCE_STACKS = (1, 2, 4, 8, 16)
#: the attention phase's shapes (the benchmark cells'): name -> (B, S, H,
#: KV, sliding window or None)
ATTENTION_CASES = {"b4s4096": (4, 4096, 32, 8, None), "b32s512": (32, 512, 32, 8, None),
                   "hymba-b4s4096": (4, 4096, 25, 5, 1024)}
ATTENTION_HEAD_DIM = 64
#: bf16 tensor-core rate of the H100 SXM (NVIDIA's data sheet, dense)
BF16_FLOPS_PER_S = 989e12
#: bf16 MMA passes of 2 x head_dim FLOPs a score element: q.k once and
#: P.V in three parts forward; the backward's S, dP (one each) and dV,
#: dK, dQ (three parts each)
ATTENTION_FWD_PASSES, ATTENTION_BWD_PASSES = 4, 11
#: the SSD phase's shape, hymba-1.5b's layer in its train cell: (B, S, H,
#: P, N, chunk)
SSD_CASE = (4, 4096, 50, 64, 16, 256)
#: bf16 MMAs of one split product: the three parts' products with i + j <= 2
SSD_MMA_PASSES = 6
#: the layers of the full-width hymba-1.5b train step whose scan launches
#: the SSD phase counts
SSD_TRAIN_LAYERS = 2
#: ptxas spills the build phase lets pass, by (library, kernel): the most
#: spill-store bytes each may show, each where the spilling build was
#: measured faster than a spill-free one (H100).  mamba2-130m's (P 64, N
#: 128) backward holds dB's [16, 128] register tile a warp through the walk
#: over the tile pairs and spills ~1.5 KB at 255 registers; keeping dC's
#: running sum in device memory cut the spill to 132 bytes and made the
#: kernel 11 % slower (2,189 against 1,976 us at [2, 2048, 24, 64]).  The
#: reduced configs' (16, 16) chunk kernel, where ptxas picks 48 registers,
#: spills 8 bytes; asking for two CTAs an SM (`__launch_bounds__(NT, 2)`)
#: removes the spill but slows it 12 % (22.8 against 20.3 us at [4, 1024,
#: 8, 16]) and hymba's instance 19 %.  No cell trains mamba2 or a reduced
#: config
SPILL_EXEMPT = {("ssd_scan (64, 128)", "ssd_backward_kernel"): 2048,
                ("ssd_scan (16, 16)", "ssd_chunk_kernel"): 8}
#: beyond 4x the plain f32 version's own error against f64, this share of
#: each result's largest value (`tests/test_torch_ssd_kernel.py`)
SSD_ATOL = 2**-20
#: with --keep-going: the kernel measurements that failed, and the
#: errors that count as a failed measurement rather than a crash
FAILURES = []
CASE_ERRORS = ()

#: relative tolerance of the float sums the service reports
#: (recoverable_s, exposure_s, score): the epilog sums in another order
#: on the card than on the CPU
SERVICE_RTOL = 1e-4


def accumulation_syncs(m: int):
    """The six-stage contract expanded for accumulation factor m (3m + 3
    stages): (S, the last microstep's backward, every backward)."""
    s = 3 * m + 3
    every = tuple(3 * i + 2 for i in range(m))
    return s, every[-1:], every


def entry_kernel(line: str) -> str:
    """The kernel's own name in ptxas's "Compiling entry function" line: the
    last name of a mangled ``_ZN`` path (each name after its length), or
    the name as it stands."""
    name = re.search(r"function '(\w+)'", line).group(1)
    i, last = 3, name
    while name.startswith("_ZN") and i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        last, i = name[j:j + int(name[i:j])], j + int(name[i:j])
    return last


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def attempt(label, fn):
    """`fn()`; with --keep-going a launch refusal or a mismatch is
    printed and recorded in FAILURES instead, and gives None."""
    try:
        return fn()
    except CASE_ERRORS as e:
        FAILURES.append(label)
        print("failed " + json.dumps(dict(label=label, error=str(e)[:300])),
              flush=True)
        return None


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
        # the two roles' thread mappings at their tails: one step; 9 and 7
        # steps, no multiple of the frontier role's 2-step chunk; R*S = 910
        # and 2,340, no multiple of 128, the last stage synced; one rank in
        # each of several jobs
        ("edge, one step", (3, 1, 130, 7), dict(sync_stages=(2, 6), hosts=4)),
        ("edge, one step, no sync", (2, 1, 9, 6), dict(sync_stages=None)),
        ("edge, 9 steps, R*S = 910, last stage synced", (3, 9, 130, 7),
         dict(sync_stages=(2, 6), hosts=4)),
        ("edge, 7 steps, 18 stages, R*S = 2340, last stage synced",
         (3, 7, 130, 18), dict(sync_stages=(2, 5, 8, 11, 14, 17), hosts=4)),
        ("edge, one rank, 5 jobs", (5, 12, 1, 6), dict(sync_stages=DDP, hosts=1)),
        # the frontier kernel's warp fold: R*S = 42 and 63, no multiple of
        # a warp's 32 lanes; 32 stages (one rank a warp); 513 ranks; the
        # max tied between ranks of different rank groups, warps and rank
        # tiles (the lowest must lead, the second equal the max), up to
        # 32 stages and past them
        ("edge, R*S = 42", (2, 5, 7, 6), dict(sync_stages=DDP, hosts=2)),
        ("edge, R*S = 63", (2, 5, 9, 7), dict(sync_stages=(2, 6), hosts=2)),
        ("edge, 32 stages", (2, 4, 5, 32), dict(sync_stages=(3, 31), hosts=2)),
        ("edge, 513 ranks", (2, 3, 513, 6), dict(sync_stages=DDP, hosts=5)),
        ("edge, ranks tied at the max", (3, 4, 300, 6),
         dict(sync_stages=DDP, hosts=3, tied=TIED_RANKS)),
        ("edge, ranks tied at the max, 33 stages", (2, 3, 300, 33),
         dict(sync_stages=(2, 32), hosts=3, tied=TIED_RANKS)),
        ("edge, one rank, 5 jobs, service call", (5, 12, 1, 6),
         dict(sync_stages=DDP, with_regimes=False)),
        # an explicit [R, S] baseline: the cell walks read it through
        # rank and stage strides, not as the prolog's broadcast medians
        ("edge, explicit baseline", (3, 11, 70, 6),
         dict(sync_stages=DDP, hosts=4, baseline=True)),
        ("edge, explicit baseline, 34 stages", (2, 11, 40, 34),
         dict(sync_stages=(5, 20, 33), hosts=4, baseline=True)),
        *many_stage_cases(),
        ("FLT_MIN-fed window", (4, 20, 130, 6),
         dict(sync_stages=(1, 4), hosts=5, tiny=(2e-38, 1e-39),
              min_excess_s=0.0, rel_excess=0.5)),
        ("fleet scale", (256, 100, 512, 8),
         dict(sync_stages=(2, 5), with_regimes=False)),
    ]


def many_stage_cases():
    """Accumulation-expanded schemas: past the 16 stages the register
    variants hold, and (33 stages) a barrier past bit 31."""
    out = []
    for m, profile in ((5, "every"), (8, "last"), (10, "every")):
        s, last, every = accumulation_syncs(m)
        sync = last if profile == "last" else every + (s - 1,)
        out.append((f"{s} stages (m={m}, {profile} backward)",
                    (8, 50, 200, s), dict(sync_stages=sync, hosts=7)))
        out.append((f"{s} stages, service call", (32, 100, 128, s),
                    dict(sync_stages=sync, with_regimes=False)))
    # past 256 stages the prefix nests blocks of blocks, at 2,400 and 2,500
    # two levels deep; 2,400 stages sit just under the former slab walk's
    # shared-memory limit, 2,500 past it
    out.append(("edge, 300 stages", (2, 6, 40, 300),
                dict(sync_stages=(17, 150, 299), hosts=3)))
    for s in (2400, 2500):
        out.append((f"edge, {s} stages", (2, 6, 40, s),
                    dict(sync_stages=(17, 300, s - 1), hosts=3)))
    return out


def flat_fields(acc):
    """Named tensors of a TickAccumulators (regime tuple flattened)."""
    out = []
    for name, v in zip(acc._fields, acc):
        if isinstance(v, tuple):
            out.extend((f"{name}[{i}]", t) for i, t in enumerate(v))
        else:
            out.append((name, v))
    return out


def compare(got, want, torch):
    """Ints exact, floats close and then bit for bit; returns the largest
    finite abs error."""
    worst = 0.0
    for (name, g), (_, w) in zip(flat_fields(got), flat_fields(want)):
        if (g is None) != (w is None):
            raise AssertionError(f"{name}: presence differs")
        if g is None:
            continue
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=name)
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"{name}: float bits differ")
            fin = torch.isfinite(w)
            if fin.any():
                worst = max(worst, (g[fin] - w[fin]).abs().max().item())
        elif not torch.equal(g, w):
            raise AssertionError(
                f"{name}: {(g != w).sum().item()} integer entries differ"
            )
    return worst


def nbytes(inputs, outputs) -> int:
    """Each input read once (distinct storages: a broadcast baseline is
    its [J, S] rows), each output written once."""
    seen, total = set(), 0
    for t in inputs:
        if t is None:
            continue
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    for t in outputs:
        if t is not None:
            total += t.numel() * t.element_size()
    return total


def bytes_moved(x, acc) -> int:
    """The fused kernel's bytes: every input it reads, every output."""
    return nbytes(
        (x.d, x.wmin, x.bd, x.bw, x.amax, x.second, x.leader, x.relprev,
         x.thr, x.host, x.sync),
        (t for _, t in flat_fields(acc)),
    )


def family_inputs(x, name):
    """The tensors each single-family kernel reads (wmin only with a
    sync stage)."""
    wmin = x.wmin if x.sync_stages else None
    if name == "frontier_window":
        return (x.d, x.bd)
    if name == "whatif_matrix":
        return (x.d, wmin, x.bw, x.amax, x.second, x.leader, x.relprev, x.sync)
    return (x.d, wmin, x.bw, x.thr, x.sync)


def bound(nbytes_, ops_per_element, elements):
    """(bound ms, what bounds it): bytes at the memory rate against the
    operations at the float32 rate."""
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_per_element * elements / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def assert_bitwise(got, want, torch, label):
    """Integer tensors equal, float tensors bit-equal."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}[{i}]: dtype or shape differs")
        if g.dtype.is_floating_point:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            raise AssertionError(
                f"{label}[{i}]: {(g != w).sum().item()} entries differ"
            )


def family_err(got, want, torch) -> float:
    """Largest |got - want| over the outputs: floats where both are
    finite (inf where their non-finite entries differ), ints as numbers."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            fin = torch.isfinite(g) & torch.isfinite(w)
            if not torch.allclose(g[~fin], w[~fin], rtol=0, atol=0,
                                  equal_nan=True):
                return float("inf")
            if fin.any():
                worst = max(worst, (g[fin] - w[fin]).abs().max().item())
        elif g.numel():
            worst = max(worst, (g.long() - w.long()).abs().max().item())
    return worst


def assert_packets_bitwise(got, want, torch, label):
    """Every family of two tick packets present on both sides and equal
    bit for bit on every field."""
    for fam in ("frontier", "whatif", "regimes", "coact"):
        a, b = getattr(got, fam), getattr(want, fam)
        if (a is None) != (b is None):
            raise AssertionError(f"{label}: {fam} presence differs")
        if a is not None:
            assert_bitwise(tuple(a), tuple(b), torch, f"{label}: {fam}")


def family_case(torch, kernels, name, x, flush) -> dict:
    """One single-family kernel against its plain version on the same
    card tensors: the error measured, then bit for bit; timed beside its
    byte bound."""
    cuda, plain = (getattr(kernels, f) for f in WRAPPERS[name])
    got = cuda(x)
    torch.cuda.synchronize()
    want = plain(x)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = family_err(got, want, torch)
    assert_bitwise(got, want, torch, name)
    ms = time_ms(lambda: cuda(x), 20, torch, flush)
    plain_ms = time_ms(lambda: plain(x), 3, torch, flush)
    moved = nbytes(family_inputs(x, name), got)
    bound_ms, bound_by = bound(moved, FAMILY_OPS_PER_ELEMENT[name], x.d.numel())
    return dict(shape=list(x.d.shape), sync=list(x.sync_stages),
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=moved)


@contextlib.contextmanager
def recording(module, wrappers, groups):
    """While open, each CUDA wrapper `wrappers[name]` of `module` keeps in
    `groups[name]` the inputs of its first launch at each (shape, sync
    stages, families); the launches themselves are unchanged."""
    saved = {name: getattr(module, cuda) for name, cuda in wrappers.items()}

    def wrap(name, launch):
        def recorded(x):
            key = (tuple(x.d.shape), x.sync_stages, x.with_regimes,
                   x.host is not None)
            groups.setdefault(name, {}).setdefault(key, x)
            return launch(x)
        return recorded

    for name, cuda in wrappers.items():
        setattr(module, cuda, wrap(name, saved[name]))
    try:
        yield groups
    finally:
        for name, cuda in wrappers.items():
            setattr(module, cuda, saved[name])


@contextlib.contextmanager
def recording_coact(coact, groups):
    """While open, every launch of the co-activation wrapper appends a copy
    of its activity tensor to `groups`; the launches are unchanged."""
    launch = coact._co_activation_cuda

    def recorded(a):
        groups.append(a.clone())
        return launch(a)

    coact._co_activation_cuda = recorded
    try:
        yield groups
    finally:
        coact._co_activation_cuda = launch


def recording_families(kernels, groups):
    """`recording` of the four-dispatch route's single-family wrappers."""
    return recording(kernels, {n: c for n, (c, _) in WRAPPERS.items()}, groups)


def recording_fused(fused, groups):
    """`recording` of the fused tick's CUDA wrapper."""
    return recording(fused, {"fused_tick": "_fused_tick_cuda"}, groups)


def group_phase(torch, kernels, label, groups, flush) -> dict:
    """Each single-family kernel against its plain version at every
    group a main-path run handed it: name -> case rows."""
    out = {}
    for name, by_key in groups.items():
        for x in by_key.values():
            row = family_case(torch, kernels, name, x, flush)
            out.setdefault(name, []).append(row)
            print(f"{label} group {name} " + json.dumps(row), flush=True)
    return out


def fused_group_phase(torch, fused, label, groups, flush) -> list:
    """The fused kernel against its plain version, bit for bit, at every
    group a main-path run handed it: case rows."""
    rows = []
    for x in groups.get("fused_tick", {}).values():
        row = dict(shape=list(x.d.shape), sync=list(x.sync_stages),
                   regimes=x.with_regimes, hosts=x.num_hosts,
                   **fused_case(torch, fused, x, flush)[1])
        rows.append(row)
        print(f"{label} group fused_tick " + json.dumps(row), flush=True)
    return rows


def fused_case(torch, fused, x, flush):
    """The fused kernel against its plain version on the same card
    tensors, bit for bit; timed beside its byte bound.  Returns (the
    kernel's and the plain version's accumulators, the measurements)."""
    got = fused._fused_tick_cuda(x)
    torch.cuda.synchronize()
    want = fused._fused_tick_plain(x)
    err = compare(got, want, torch)
    ms = time_ms(lambda: fused._fused_tick_cuda(x), 20, torch, flush)
    plain_ms = time_ms(lambda: fused._fused_tick_plain(x), 3, torch, flush)
    moved = bytes_moved(x, got)
    bound_ms, bound_by = bound(moved, OPS_PER_ELEMENT, x.d.numel())
    return (got, want), dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, bytes=moved,
    )


def four_dispatch_case(torch, fused, kernels, label, x, kw, flush):
    """The three single-family kernels against their plain versions on
    the same inputs (bit for bit), timed beside their byte bounds; then
    `four_dispatch_tick` against `fused_fleet_tick` on the card, bit for
    bit.  The regime kernel needs the prolog's threshold: a case without
    regimes or hosts builds its inputs once more with regimes."""
    xr = x
    if x.thr is None:
        xr = fused.tick_inputs(x.d, **{**kw, "with_regimes": True})
    out = {}
    for name in FOUR_DISPATCH:
        row = attempt(f"{label} {name}", lambda: family_case(
            torch, kernels, name, xr if name == "regime_stats" else x, flush))
        if row is not None:
            out[name] = row

    def routes_agree():
        four = fused.four_dispatch_tick(x.d, **kw)
        one = fused.fused_fleet_tick(x.d, **kw)
        torch.cuda.synchronize()
        assert_packets_bitwise(four, one, torch, "four-dispatch vs fused")

    attempt(f"{label} four-dispatch vs fused", routes_agree)
    return out


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


def kernel_phase(torch, np, fused, kernels, flush):
    rows = []
    for label, shape, kw in kernel_cases():
        kw = dict(kw)
        hosts = kw.pop("hosts", 0)
        tiny = kw.pop("tiny", None)
        tied = kw.pop("tied", ())
        rng = np.random.default_rng(sum(shape) + hosts)
        if tiny is None:
            d = rng.exponential(0.03, shape).astype(np.float32)
        else:   # base + 0..59 steps: excesses and sums around FLT_MIN
            base, step = tiny
            k = rng.integers(0, 60, shape).astype(np.float32)
            d = (np.float32(base) + k * np.float32(step)).astype(np.float32)
        if tied:  # one row above every rank's, copied into the tied ranks
            d[:, :, list(tied), :] = d.max(axis=2, keepdims=True) + 0.01
        if hosts:
            kw["host_index"] = rng.integers(0, hosts, (shape[0], shape[2]))
            kw["num_hosts"] = hosts
        if kw.get("baseline"):
            kw["baseline"] = rng.exponential(0.03, shape[2:]).astype(np.float32)
        x = fused.tick_inputs(torch.from_numpy(d).cuda(), **kw)
        if tied:
            f, fl, fs, _ = kernels._frontier_cuda(x)
            if not (bool((fl == min(tied)).all()) and torch.equal(fs, f)):
                raise AssertionError(f"{label}: the lowest tied rank must lead")

        def fused_checked():
            (got, want), measured = fused_case(torch, fused, x, flush)
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
            # the whole public call (prolog + kernel + epilog) from a CUDA
            # tensor
            measured["tick_ms"] = wall_ms(
                lambda: fused.fused_fleet_tick(x.d, **kw), 5, torch
            )
            return measured

        measured = attempt(f"{label} fused_tick", fused_checked) or {}
        row = dict(
            label=label, shape=list(shape),
            sync=list(kw.get("sync_stages") or ()),
            regimes=bool(kw.get("with_regimes", True)), hosts=hosts,
            **measured,
            four_dispatch=four_dispatch_case(
                torch, fused, kernels, label, x, kw, flush),
        )
        rows.append(row)
        print("kernel case " + json.dumps(row), flush=True)
    return rows


def attention_grad_errors(torch, fn, plain, q, k, v, dout) -> dict:
    """The kernel's dq, dk and dv (through `fn`) against the plain walk's
    taken in f32 on the same values and rounded once to bf16 (the bf16
    walk sums each chunk's share of a gradient in bf16, the kernel in
    f32), within the card tests' limits: 1e-5 of the largest value (f32
    sums over up to 16,384 rows in another order) plus one bf16 rounding
    (2**-7 relative).  Returns each gradient's greatest difference."""
    def grads(f, *t):
        t = [x.detach().requires_grad_() for x in t]
        return torch.autograd.grad(f(*t), t, dout.to(t[0].dtype))

    got = grads(fn, q, k, v)
    want = [g.to(q.dtype) for g in grads(plain, q.float(), k.float(), v.float())]
    errors = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=1e-5 * scale, rtol=2**-7,
                                   msg=lambda m, n=name: f"attention {n}: {m}")
        errors[name] = float((a.float() - b.float()).abs().max())
        errors[name + "_of_max"] = errors[name] / scale
    return errors


def attention_phase(torch, flush) -> list:
    """The attention kernel at the cells' shapes: its output and its three
    gradients against the plain walk's, then kernel, plain and library
    times (CUDA events)."""
    from repro_torch.kernels.attention import causal
    from repro_torch.models import attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    d = ATTENTION_HEAD_DIM
    for name, (b, s, h, kv, window) in ATTENTION_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(11)
        q = (2 * torch.randn((b, s, h, d), generator=g, device="cuda")).bfloat16()
        k = (2 * torch.randn((b, s, kv, d), generator=g, device="cuda")).bfloat16()
        v = torch.randn((b, s, kv, d), generator=g, device="cuda").bfloat16()
        dout = torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16()
        chunk = min(s, 1024)

        def plain(*t):
            return attention.chunked_causal_attention_plain(*t, q_chunk=chunk, kv_chunk=chunk,
                                                            window=window)

        def kernel(*t):
            return attention.chunked_causal_attention(*t, q_chunk=chunk, kv_chunk=chunk,
                                                      window=window)

        with torch.no_grad():
            got = kernel(q, k, v)
            want = plain(q, k, v)
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-4)
        err = float((got.float() - want.float()).abs().max())
        del got, want
        grad_errors = attention_grad_errors(torch, kernel, plain, q, k, v, dout)
        torch.cuda.empty_cache()
        spec = causal._spec(q, k, window, True, None, chunk)
        _, o32, lse = causal._forward(q, k, v, spec, save=True)

        def with_grad(fn, *t):
            t = [x.detach().requires_grad_() for x in t]
            torch.autograd.grad(fn(*t), t, dout)

        # the library takes [B, H, S, D] with K/V heads repeated for GQA;
        # a window as a mask of the keys each query may read
        ql = q.transpose(1, 2).contiguous()
        kl, vl = (x.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
                  for x in (k, v))
        pos = torch.arange(s, device="cuda")
        mask = None if window is None else (
            (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window))

        def library(*t):
            if mask is None:
                return sdpa(*t, is_causal=True)
            return sdpa(*t, attn_mask=mask)

        w = s if window is None else window
        elements = b * h * sum(min(i + 1, w) for i in range(s))
        flops = 2 * d * elements
        row = dict(
            case=name, shape=[b, s, h, d], kv_heads=kv, window=window, max_abs_err=err,
            grad_max_abs_err=max(grad_errors[n] for n in ("dq", "dk", "dv")),
            grad_errors=grad_errors,
            ms=time_ms(lambda: causal._forward(q, k, v, spec, save=True), 10, torch, flush),
            bwd_ms=time_ms(lambda: causal._backward(q, k, v, o32, lse, dout, spec),
                           10, torch, flush),
            bound_ms=ATTENTION_FWD_PASSES * flops / BF16_FLOPS_PER_S * 1e3,
            bwd_bound_ms=ATTENTION_BWD_PASSES * flops / BF16_FLOPS_PER_S * 1e3,
            bound_by="bf16 tensor-core FLOPs",
            plain_ms=time_ms(lambda: plain(q, k, v).sum(), 3, torch, flush),
            plain_fwd_bwd_ms=time_ms(lambda: with_grad(plain, q, k, v), 2, torch, flush),
            library_ms=time_ms(lambda: library(ql, kl, vl), 10, torch, flush),
            library_fwd_bwd_ms=time_ms(lambda: with_grad(
                lambda *t: library(*t).transpose(1, 2), ql, kl, vl),
                10, torch, flush),
            launches_fwd=1, launches_bwd=2)
        row["fwd_bwd_ms"] = row["ms"] + row["bwd_ms"]
        rows.append(row)
        print("attention " + json.dumps(row), flush=True)
        del q, k, v, dout, o32, lse, ql, kl, vl, mask
        torch.cuda.empty_cache()
    return rows


def ssd_inputs(torch, b, s, h, hp, n):
    """(xh, dt, a, d, b, c, dy) at the scale of the benchmark's weights
    (Mamba-2's decays: A = -U(1, 16), dt the softplus of N(0, 1) plus an
    inverse softplus of a step log-uniform in [1e-3, 1e-1]); xh, b and c
    sliced from one conv output, as `apply_ssm` passes them."""
    g = torch.Generator(device="cuda").manual_seed(13)

    def draw(*shape, rand=False):
        return (torch.rand if rand else torch.randn)(shape, generator=g, device="cuda")

    a = -(1.0 + 15.0 * draw(h, rand=True))
    step = torch.exp(math.log(1e-3) + draw(h, rand=True) * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = step + torch.log(-torch.expm1(-step))
    dt = torch.logaddexp(draw(b, s, h) + dt_bias, torch.zeros((), device="cuda"))
    whole = draw(b, s, h * hp + 2 * n)
    return (whole[..., :h * hp].reshape(b, s, h, hp), dt, a, 1.0 + 0.3 * draw(h),
            whole[..., h * hp:h * hp + n], whole[..., h * hp + n:], draw(b, s, h, hp))


def ssd_phase(torch, flush) -> dict:
    """The SSD scan's kernels at hymba-1.5b's layer shape: output and the
    six gradients against the plain `_ssd`, each held to the plain version
    in f64 within the card tests' limit, then kernel and plain times (CUDA
    events) beside the bound."""
    from repro_torch.kernels.ssd import scan
    from repro_torch.models import ssm

    b, s, h, hp, n, q = SSD_CASE
    *ins, dy = ssd_inputs(torch, b, s, h, hp, n)

    def run(fn, dtype=None):
        t = [(x if dtype is None else x.to(dtype)).detach().requires_grad_() for x in ins]
        y = fn(*t)
        return [x.detach() for x in (y, *torch.autograd.grad(y, t, dy.to(y.dtype)))]

    got = run(lambda *t: ssm._ssd(*t, q))
    plain = run(lambda *t: ssm._ssd_plain(*t, q))
    exact = run(lambda *t: ssm._ssd_plain(*t, q), torch.float64)
    errors = {}
    for name, k, p, e in zip(("y", "dxh", "ddt", "da", "dd", "db", "dc"), got, plain, exact):
        err_k = float((k.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        scale = float(e.abs().max())
        if not err_k <= 4 * err_p + SSD_ATOL * scale:
            raise AssertionError(f"ssd {name}: kernel {err_k:.3e} off f64, plain {err_p:.3e}")
        errors[name] = dict(kernel=err_k, plain=err_p, of_max=err_k / scale)
    del got, plain, exact
    torch.cuda.empty_cache()

    xh, dt, a, d, b_, c_ = ins
    y, hin = scan._forward(xh, dt, a, d, b_, c_, q)

    def with_grad(fn):
        t = [x.detach().requires_grad_() for x in ins]
        torch.autograd.grad(fn(*t), t, dy)

    # the work by kernel, per (batch, chunk): the chunk kernel's products
    # (C.B^T's lower triangle, the chunk states or their gradients) are
    # f32 FMA; the output and backward kernels' are split products, each
    # `SSD_MMA_PASSES` bf16 MMAs; fwd FMA + MMA is `scan_flops`
    nc, tri = s // q, q * (q + 1) // 2
    state = 2 * q * n * h * hp
    fma = b * nc * (tri * 2 * n + state)
    mma = b * nc * (tri * 2 * h * hp + state)
    bwd_mma = b * nc * (tri * (4 * h * hp + 4 * h * n) + 3 * state)
    f32 = 4
    fwd_bytes = f32 * (2 * b * s * h * hp + b * s * h + 2 * b * s * n)
    bwd_bytes = f32 * (3 * b * s * h * hp + 2 * b * s * h + 4 * b * s * n + b * nc * h * n * hp)

    def bound(mma_, bytes_):
        flops_s = fma / F32_OPS_PER_S + SSD_MMA_PASSES * mma_ / BF16_FLOPS_PER_S
        bytes_s = bytes_ / HBM_BYTES_PER_S
        return max(flops_s, bytes_s) * 1e3, "FLOPs" if flops_s > bytes_s else "bytes"

    bound_ms, fwd_by = bound(mma, fwd_bytes)
    bwd_bound_ms, bwd_by = bound(bwd_mma, bwd_bytes)
    row = dict(
        case="hymba-layer", shape=[b, s, h, hp], state=n, chunk=q, errors=errors,
        max_abs_err=errors["y"]["kernel"],
        grad_max_abs_err=max(v["kernel"] for k_, v in errors.items() if k_ != "y"),
        ms=time_ms(lambda: scan._forward(xh, dt, a, d, b_, c_, q), 10, torch, flush),
        bwd_ms=time_ms(lambda: scan._backward(xh, dt, a, d, b_, c_, hin, dy, q),
                       10, torch, flush),
        bound_ms=bound_ms, bwd_bound_ms=bwd_bound_ms,
        bound_by=f"forward {fwd_by}, backward {bwd_by}: the larger of the chunk kernel's "
                 f"FLOPs at 67 TFLOP/s of f32 FMA plus the split products' "
                 f"{SSD_MMA_PASSES} bf16 MMA passes at 989 TFLOP/s, and the bytes at 3.35 TB/s",
        fma_flops=fma, mma_flops=mma, bwd_fma_flops=fma, bwd_mma_flops=bwd_mma,
        bytes=fwd_bytes, bwd_bytes=bwd_bytes,
        plain_ms=time_ms(lambda: ssm._ssd_plain(*ins, q), 3, torch, flush),
        plain_fwd_bwd_ms=time_ms(lambda: with_grad(lambda *t: ssm._ssd_plain(*t, q)),
                                 2, torch, flush))
    del y, hin, ins, dy
    torch.cuda.empty_cache()
    row.update(ssd_train_launches(torch, scan))
    row["fwd_bwd_ms"] = row["ms"] + row["bwd_ms"]
    print("ssd " + json.dumps(row), flush=True)
    return row


def ssd_train_launches(torch, scan) -> dict:
    """The scan's kernel launches in one train step of hymba-1.5b at full
    width, cut to `SSD_TRAIN_LAYERS` layers (remat on, batch 2 x 2,048),
    counted from zero: each layer's scan runs its forward twice (the pass
    and the layer's recompute) and its backward once, so each forward
    kernel must launch 2 x layers times and each backward kernel layers
    times.  Returns the counts and their sum."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import BASELINE_PLAN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=SSD_TRAIN_LAYERS)
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), device="cuda")
    step, _ = build_train_step(model, make_local_mesh(device="cuda"), BASELINE_PLAN,
                               AdamWConfig())
    tokens = torch.randint(0, cfg.vocab_size, (2, 2049), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(17))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    for key in scan.launches:
        scan.launches[key] = 0
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts = dict(scan.launches)
    if not torch.isfinite(metrics["loss"]):
        raise AssertionError(f"the hymba train step's loss is {float(metrics['loss'])}")
    calls = {"forward": (1 + bool(cfg.remat)) * cfg.n_layers, "backward": cfg.n_layers}
    sums = {way: sum(v for k, v in counts.items() if k.startswith(way)) for way in calls}
    if any(v != calls[k.split("_")[0]] for k, v in counts.items()) or sums != {
            "forward": 3 * calls["forward"], "backward": 4 * calls["backward"]}:
        raise AssertionError(f"the hymba train step launched {counts} for {calls} scan calls")
    del state, step, model, batch, tokens
    torch.cuda.empty_cache()
    return dict(train_launches=counts, train_scan_calls=calls,
                launches_fwd=sums["forward"], launches_bwd=sums["backward"])


def phase_split(out) -> dict:
    """The service's own per-phase seconds (obs histograms)."""
    hist = (out.get("obs") or {}).get("metrics", {}).get("histograms", {})
    return {
        name.split("phase_seconds.", 1)[1]: h["sum"]
        for name, h in hist.items() if name.startswith("phase_seconds.")
    }


def serve(serve_fleet, argv):
    """One `serve_fleet.run` and its host-clock seconds."""
    t0 = time.perf_counter()
    out = serve_fleet.run(serve_fleet.make_argparser().parse_args(argv))
    return out, time.perf_counter() - t0


def check_routes(out, ref) -> None:
    """Routes of a cuda run against a cpu run: same (job, stage, rank),
    recoverable seconds within SERVICE_RTOL; snapshots equal."""
    routes = out["routing"]
    key = [(r["job"], r["stage"], r["rank"]) for r in routes]
    ref_key = [(r["job"], r["stage"], r["rank"]) for r in ref["routing"]]
    if key != ref_key:
        raise AssertionError(f"cuda routes {key} != cpu routes {ref_key}")
    for a, b in zip(routes, ref["routing"]):
        tol = SERVICE_RTOL * abs(b["recoverable_s"]) + 1e-4
        if abs(a["recoverable_s"] - b["recoverable_s"]) > tol:
            raise AssertionError(f"recoverable_s {a} vs {b}")
    if out["snapshot"] != ref["snapshot"]:
        raise AssertionError("cuda and cpu snapshots differ")


def close(a: float, b: float) -> bool:
    return abs(a - b) <= SERVICE_RTOL * abs(b) + 1e-4


def check_incidents(out, ref) -> None:
    """Incident table and escalation plan of a cuda run against a cpu
    run: every field equal, the float sums within SERVICE_RTOL."""
    sums = {"exposure_s", "score"}
    for name in ("incidents", "escalations"):
        got, want = out[name], ref[name]
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} rows vs {len(want)}")
        for g, w in zip(got, want):
            if sorted(g) != sorted(w) or any(
                g[k] != w[k] for k in g if k not in sums
            ) or any(not close(g[k], w[k]) for k in g if k in sums):
                raise AssertionError(f"{name}: {g} vs {w}")


def fabric_phase(fused, kernels, coact, serve_fleet):
    """`serve_fleet --topology fabric` on the card: both kernels launch,
    one switch-tier incident forms on the shared uplink, and the answer
    equals a cpu run.  Returns the co-activation launches and the
    activity tensors the engine scored (the service's own groups)."""
    groups = []
    reset_launches(fused, kernels, coact)
    with recording_coact(coact, groups):
        out, wall = serve(serve_fleet, FABRIC_ARGS + ["--device", "cuda"])
    launches = read_launches(fused, kernels, coact)
    if min(launches["fused_tick"], launches["coactivation"]) <= 0 or any(
        launches[k] for k in FOUR_DISPATCH
    ):
        raise AssertionError(f"the fabric run launched {launches}")
    fleet = [r for r in out["incidents"] if r["scope"] == "fleet"]
    if [(r["tier"], r["host"]) for r in fleet] != [("switch", FABRIC_SWITCH)]:
        raise AssertionError(f"fabric fleet incidents: {fleet}")
    ref, cpu_wall = serve(serve_fleet, FABRIC_ARGS + ["--device", "cpu"])
    check_routes(out, ref)
    check_incidents(out, ref)
    split = phase_split(out)
    if "tick.correlate" not in split:
        raise AssertionError(f"no tick.correlate phase in {sorted(split)}")
    print("fabric " + json.dumps(dict(
        launches=launches, wall_s=wall, cpu_wall_s=cpu_wall,
        group_shapes=[list(g.shape) for g in groups],
        fleet_incident=fleet[0], incidents=len(out["incidents"]),
        escalations=len(out["escalations"]),
        phase_seconds=split,
    )), flush=True)
    return launches["coactivation"], groups


def coact_cases(torch, groups, replay_groups):
    """(label, act) of every co-activation kernel case: the fabric run's
    and the replay's own group tensors first, then edge and fleet-scale
    shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def act(shape, p=0.3):
        r = torch.rand(shape, generator=gen, device="cuda")
        return (r < p).view(torch.uint8)

    cases = []
    for label, run in (("fabric service", groups), ("replay", replay_groups)):
        seen = set()
        for g in run:    # the first group of each shape the run scored
            if tuple(g.shape) not in seen:
                seen.add(tuple(g.shape))
                cases.append((f"{label} group {len(seen) - 1}", g))
    # one column active in one job only, at every other step: jobs 1,
    # coact 0, active 25 there
    single = torch.zeros((8, 50, 6, 6), dtype=torch.uint8, device="cuda")
    single[3, ::2, 2, 4] = 1
    cases += [
        ("edge, one job", act((1, 40, 7, 6))),
        ("edge, one host", act((5, 30, 1, 6))),
        ("edge, 5 stages", act((6, 33, 130, 5))),
        # job counts no multiple of the kernel's job split (67), and past
        # one round of it (130); one step; 37 steps, no multiple of a load
        # batch; C*S = 111 and 1,200, no multiple of a column tile (one
        # column a lane, four); every entry 1; every entry 0
        ("edge, 67 jobs", act((67, 20, 5, 6))),
        ("edge, 130 jobs", act((130, 9, 3, 2))),
        ("edge, one step", act((9, 1, 40, 6))),
        ("edge, 37 steps", act((12, 37, 10, 6))),
        ("edge, C*S = 111", act((5, 17, 37, 3))),
        ("edge, C*S = 1200", act((6, 9, 300, 4))),
        ("edge, all ones", act((10, 30, 20, 6), p=1.0)),
        ("edge, all zeros", act((10, 30, 20, 6), p=0.0)),
        ("edge, one job on a column", single),
        # long windows in one chunk of the kernel's step array, and past
        # it (two chunks)
        ("edge, 1000 steps", act((40, 1000, 8, 2))),
        ("edge, 140 jobs x 800 steps", act((140, 800, 3, 2), p=0.1)),
        ("edge, 2500 steps", act((40, 2500, 8, 2))),
        ("edge, 140 jobs x 2000 steps", act((140, 2000, 3, 2), p=0.1)),
        # past the job array's former shared-memory limit: 16-block
        # clusters (one column tile), 8-block ones (17 tiles), and a
        # window past one step chunk as well (act read twice, 131 MB)
        ("many jobs, 32768 x 20 x 4 x 2", act((32768, 20, 4, 2), p=0.1)),
        ("many jobs, 16384 x 4 x 68 x 8", act((16384, 4, 68, 8), p=0.1)),
        ("many jobs, 32768 x 2000 x 1 x 2", act((32768, 2000, 1, 2), p=0.05)),
    ]
    # 256 jobs x 400 steps x (512 hosts + 64 switches + 8 pods) x 8 stages
    cases.append(("fleet scale", act((256, 400, 512 + 64 + 8, 8), p=0.05)))
    return cases


def coact_check(torch, coact, label, a) -> float:
    """The co-activation kernel against its plain version on `a`,
    exactly; returns the largest error (0)."""
    got = coact._co_activation_cuda(a)
    torch.cuda.synchronize()
    want = coact._co_activation_plain(a)
    err = family_err(got, want, torch)
    for name, u, v in zip(got._fields, got, want):
        if not torch.equal(u, v):
            raise AssertionError(
                f"{label}: {name}: {(u != v).sum().item()} entries differ"
            )
    if label == "edge, one job on a column" and [
        int(t[4, 2]) for t in got
    ] != [1, 0, 25]:
        raise AssertionError(f"{label}: {[int(t[4, 2]) for t in got]}")
    return err


def coact_phase(torch, np, coact, groups, replay_groups, flush):
    """The co-activation kernel against its plain version on the card,
    exactly, then timed beside its byte bound."""
    # the tiered prolog with unmapped (-1) hosts: the combined columns
    # are what the kernel scores, and each tier must equal the oracle
    rng = np.random.default_rng(9)
    host_act = rng.random((4, 25, 12, 6)) < 0.3
    tiers = (coact.TierAxes("switch", 4, tuple(int(g) for g in rng.integers(-1, 4, 12))),
             coact.TierAxes("pod", 2, tuple(int(g) for g in rng.integers(-1, 2, 12))))
    for i, (g, w) in enumerate(zip(
        coact.tiered_co_activation(host_act, tiers, device="cuda"),
        coact.tiered_co_activation_ref(host_act, tiers),
    )):
        for name, u, v in zip(g._fields, g, w):
            if not np.array_equal(u.cpu().numpy(), v):
                raise AssertionError(f"tier {i} {name} differs from the oracle")
    segments = [torch.from_numpy(host_act).cuda().view(torch.uint8)]
    segments += [coact._collapse_tier(segments[0], t) for t in tiers]
    cases = coact_cases(torch, groups, replay_groups)
    cases.append(("edge, tiers with unmapped hosts",
                  torch.cat(segments, dim=2).contiguous()))
    rows = []
    for label, a in cases:
        err = attempt(f"coact {label}", lambda: coact_check(torch, coact, label, a))
        if err is None:
            continue
        ms = time_ms(lambda: coact._co_activation_cuda(a), 20, torch, flush)
        plain_ms = time_ms(lambda: coact._co_activation_plain(a), 3, torch, flush)
        j, n, h, s = a.shape
        nbytes = a.numel() + 3 * s * h * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = COACT_OPS_PER_ELEMENT * a.numel() / F32_OPS_PER_S * 1e3
        row = dict(
            label=label, shape=list(a.shape), density=a.float().mean().item(),
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes,
        )
        rows.append(row)
        print("coact case " + json.dumps(row), flush=True)
    return rows


def service_phase(fused, kernels, coact, serve_fleet):
    reset_launches(fused, kernels, coact)
    out, wall = serve(serve_fleet, SERVICE_ARGS + ["--device", "cuda"])
    counts = read_launches(fused, kernels, coact)
    launches = counts.pop("fused_tick")
    if launches <= 0 or any(counts.values()):
        raise AssertionError(f"the service run launched {launches} ticks, {counts}")
    routes = out["routing"]
    if not routes:
        raise AssertionError("the service returned no route")
    top = int(routes[0]["job"].split("-")[1])
    if top % 3 != 0:  # serve_fleet faults every 3rd job by default
        raise AssertionError(f"top route {routes[0]['job']} is not a faulted job")
    ref, cpu_wall = serve(serve_fleet, SERVICE_ARGS + ["--device", "cpu"])
    check_routes(out, ref)
    obs = out.get("obs") or {}
    summary = dict(
        launches=launches, wall_s=wall, cpu_wall_s=cpu_wall,
        top_route=routes[0], routes=len(routes),
        phase_seconds=phase_split(out),
        tick_frontier=obs.get("tick_frontier"),
    )
    print("service " + json.dumps(summary), flush=True)
    return launches


def reset_launches(fused, kernels, coact) -> None:
    """Every kernel's launch count to 0, just before a main-path run."""
    fused.launches = 0
    coact.launches = 0
    for name in kernels.launches:
        kernels.launches[name] = 0


def read_launches(fused, kernels, coact) -> dict:
    return {"fused_tick": fused.launches, "coactivation": coact.launches,
            **kernels.launches}


def tick_phase(torch, np, fused, kernels, coact):
    """The public `four_dispatch_tick` with every family at the service
    shape: each of its four kernels launches once, the fused kernel never,
    and the packet equals `fused_fleet_tick`'s bit for bit.  Returns the
    launch counts of the four-dispatch call and the inputs each
    single-family kernel was handed."""
    rng = np.random.default_rng(64)
    d = rng.exponential(0.03, (64, 100, 128, 6)).astype(np.float32)
    kw = dict(sync_stages=DDP, host_index=rng.integers(0, 64, (64, 128)),
              num_hosts=64, with_regimes=True)
    groups = {}
    reset_launches(fused, kernels, coact)
    t0 = time.perf_counter()
    with recording_families(kernels, groups):
        four = fused.four_dispatch_tick(d, **kw)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches(fused, kernels, coact)
    want = {"fused_tick": 0, "coactivation": 1, "frontier_window": 1,
            "whatif_matrix": 1, "regime_stats": 1}
    if launches != want:
        raise AssertionError(f"four_dispatch_tick launched {launches}")
    one = fused.fused_fleet_tick(d, **kw)
    torch.cuda.synchronize()
    assert_packets_bitwise(four, one, torch, "tick phase")
    if four.whatif.matrix.shape != (64, 6, 128) or not bool(
        torch.isfinite(four.whatif.matrix).all()
    ):
        raise AssertionError("four-dispatch what-if matrix is not finite [J, S, R]")
    print("tick " + json.dumps(dict(
        launches=launches, wall_s=wall_s,
        active_cells=int(four.regimes.count.gt(0).sum().item()),
        coactive_hosts=int(four.coact.jobs.ge(2).sum().item()),
    )), flush=True)
    return launches, groups


def replay_report(out) -> dict:
    return {k: v for k, v in out.items() if k not in REPLAY_VOLATILE}


def replay_phase(fused, kernels, coact, replay, fused_groups, coact_groups):
    """The replay driver's four-dispatch route on the card: its kernels
    launch (the fused one never), one switch-tier incident forms on the
    shared uplink, and the fused route's report is the same outside the
    wall-clock fields.  Returns the four-dispatch run's launch counts and
    the groups (inputs at each shape, sync set and families) its kernels
    were handed; the fused run's groups go into `fused_groups`, the
    activity tensors the four-dispatch run scored into `coact_groups`."""
    runs, groups = {}, {}
    for path in ("four-dispatch", "fused"):
        argv = REPLAY_ARGS + ["--tick-path", path, "--device", "cuda"]
        reset_launches(fused, kernels, coact)
        t0 = time.perf_counter()
        by_family = path == "four-dispatch"
        record = (recording_families(kernels, groups) if by_family
                  else recording_fused(fused, fused_groups))
        with record, recording_coact(coact, coact_groups if by_family else []):
            out = replay.run(replay.make_argparser().parse_args(argv))
        runs[path] = (out, time.perf_counter() - t0,
                      read_launches(fused, kernels, coact))
    four, four_wall, launches = runs["four-dispatch"]
    one, one_wall, one_launches = runs["fused"]
    if launches["fused_tick"] or min(
        launches[k] for k in ("frontier_window", "whatif_matrix", "coactivation")
    ) <= 0:
        raise AssertionError(f"the four-dispatch replay launched {launches}")
    if one_launches["fused_tick"] <= 0 or any(
        one_launches[k] for k in FOUR_DISPATCH
    ):
        raise AssertionError(f"the fused replay launched {one_launches}")
    fleet = [r for r in four["incidents"] if r["scope"] == "fleet"]
    if [(r["tier"], r["host"]) for r in fleet] != [("switch", FABRIC_SWITCH)]:
        raise AssertionError(f"replay fleet incidents: {fleet}")
    if replay_report(four) != replay_report(one):
        diff = sorted(k for k in replay_report(one)
                      if four.get(k) != one.get(k))
        raise AssertionError(f"four-dispatch and fused reports differ in {diff}")
    if four["windows_replayed"] <= 0 or four["loader"]["skipped"]:
        raise AssertionError("the replay replayed nothing or skipped rows")
    print("replay " + json.dumps(dict(
        launches=launches, fused_launches=one_launches,
        wall_s=four_wall, fused_wall_s=one_wall,
        windows_replayed=four["windows_replayed"],
        groups={name: [[list(shape), list(sync)] for shape, sync, *_ in by_key]
                for name, by_key in groups.items()},
        coact_group_launches={
            "x".join(map(str, shape)): n for shape, n in sorted(
                Counter(tuple(g.shape) for g in coact_groups).items())
        },
        accuracy_top2=four["accuracy_top2"],
        fleet_incident=fleet[0], incidents=len(four["incidents"]),
        phase_seconds=phase_split(four),
        fused_phase_seconds=phase_split(one),
    )), flush=True)
    return launches, groups


def j_invariance_case(torch, np, fused, kernels, fused_groups, family_groups):
    """The tick's per-job results do not depend on how many jobs share
    its launch: the fused and the four-dispatch tick of 32 jobs against
    the same jobs stacked 1, 2, 4, 8 and 16 at a time (the group sizes
    a shard pads to), every family bit for bit.  A shard's group stacks
    fewer jobs than the whole fleet's.  The kernels' inputs at every
    stack, the whole one included, go into `fused_groups` and
    `family_groups`, for the group phases to hold against the plain
    versions."""
    rng = np.random.default_rng(17)
    d = rng.exponential(0.03, J_INVARIANCE_SHAPE).astype(np.float32)
    d[::3, :, 7, 1] += 0.15
    jn = d.shape[0]
    calls = 0
    for route in (fused.fused_fleet_tick, fused.four_dispatch_tick):
        for regimes in (False, True):
            kw = dict(sync_stages=DDP, with_regimes=regimes)
            with recording_fused(fused, fused_groups), \
                    recording_families(kernels, family_groups):
                whole = route(torch.from_numpy(d).cuda(), **kw)
            for j in J_INVARIANCE_STACKS:
                for lo in range(0, jn, j):
                    with recording_fused(fused, fused_groups), \
                            recording_families(kernels, family_groups):
                        part = route(torch.from_numpy(d[lo:lo + j]).cuda(), **kw)
                    calls += 1
                    for fam in ("frontier", "whatif", "regimes"):
                        a, b = getattr(part, fam), getattr(whole, fam)
                        if a is None:
                            continue
                        assert_bitwise(
                            tuple(a), tuple(t[lo:lo + j] for t in b), torch,
                            f"{route.__name__} J={j} jobs {lo}.. {fam}",
                        )
    torch.cuda.synchronize()
    return dict(calls=calls, whole=list(d.shape),
                stacked=list(J_INVARIANCE_STACKS))


def counter(out, name) -> int:
    """A counter of a run's merged self-observability metrics."""
    return out["obs"]["metrics"]["counters"].get(name, 0)


def run_summary(out, wall) -> dict:
    """A run's wall seconds, phase split and the coordinator's tick
    frontier (its slowest shard and phase)."""
    tf = (out.get("obs") or {}).get("tick_frontier") or {}
    return dict(wall_s=wall, phase_seconds=phase_split(out),
                slowest=tf.get("slowest"), frontier_shards=tf.get("shards"),
                exposed_s=tf.get("exposed_s"))


def shard_phase(torch, np, fused, kernels, coact, serve_fleet, replay,
                fused_groups, family_groups):
    """The sharded service on the card: the tick's per-job results
    against J, the sharded fabric runs against the unsharded card run
    (exactly) and a cpu run, and the sharded replay on both tick paths
    against the unsharded fused replay.  Every launch count is reset
    just before each run and read just after it.  The inputs the
    sharded runs and the J case hand the fused kernel go into
    `fused_groups`, those they hand the single-family kernels into
    `family_groups`: the group phases hold each against its plain
    version."""
    print("shard j-invariance " + json.dumps(j_invariance_case(
        torch, np, fused, kernels, fused_groups, family_groups)), flush=True)

    served = {}
    for label, extra in [("unsharded", []), *(
        (f"{n} {w}", ["--shards", str(n), "--shard-workers", w])
        for n, w in SHARD_RUNS
    )]:
        reset_launches(fused, kernels, coact)
        with recording_fused(fused, fused_groups if extra else {}):
            out, wall = serve(serve_fleet, FABRIC_ARGS + extra + ["--device", "cuda"])
        launches = read_launches(fused, kernels, coact)
        served[label] = (out, wall, launches)
        groups = counter(out, "groups_refreshed")
        if launches["fused_tick"] != groups or groups <= 0 or any(
            launches[k] for k in FOUR_DISPATCH
        ):
            raise AssertionError(
                f"fabric {label}: launched {launches} for {groups} group refreshes"
            )
        fleet = [r for r in out["incidents"] if r["scope"] == "fleet"]
        if [(r["tier"], r["host"]) for r in fleet] != [("switch", FABRIC_SWITCH)]:
            raise AssertionError(f"fabric {label}: fleet incidents {fleet}")
        print(f"shard fabric {label} " + json.dumps(dict(
            shards=out["shards"], launches=launches, group_refreshes=groups,
            **run_summary(out, wall),
        )), flush=True)
    one, _, one_launches = served.pop("unsharded")
    cpu, cpu_wall = serve(serve_fleet, FABRIC_ARGS + ["--shards", "3", "--device", "cpu"])
    for label, (out, _, launches) in served.items():
        for key in ("routing", "snapshot", "incidents", "escalations"):
            if out[key] != one[key]:
                raise AssertionError(f"fabric {label}: {key} differs from unsharded")
        check_routes(out, cpu)
        check_incidents(out, cpu)
        if launches["coactivation"] != one_launches["coactivation"]:
            raise AssertionError(
                f"fabric {label}: {launches['coactivation']} co-activation "
                f"launches, unsharded {one_launches['coactivation']}"
            )
    print("shard fabric cpu " + json.dumps(dict(cpu_wall_s=cpu_wall)), flush=True)

    reports = {}
    for label, extra in (("unsharded fused", ["--tick-path", "fused"]),
                         ("3 fused", ["--tick-path", "fused", "--shards", "3"]),
                         ("3 four-dispatch", ["--tick-path", "four-dispatch",
                                              "--shards", "3"])):
        argv = REPLAY_ARGS + extra + ["--device", "cuda"]
        sharded = "--shards" in extra
        reset_launches(fused, kernels, coact)
        t0 = time.perf_counter()
        with recording_fused(fused, fused_groups if sharded else {}), \
                recording_families(kernels, family_groups if sharded else {}):
            out = replay.run(replay.make_argparser().parse_args(argv))
        wall = time.perf_counter() - t0
        launches = read_launches(fused, kernels, coact)
        reports[label] = (out, launches)
        groups = counter(out, "groups_refreshed")
        route = ("fused_tick",) if "fused" in label else (
            "frontier_window", "whatif_matrix")
        other = set(FOUR_DISPATCH + ("fused_tick",)) - set(route)
        if groups <= 0 or any(launches[k] != groups for k in route) or any(
            launches[k] for k in other
        ):
            raise AssertionError(
                f"replay {label}: launched {launches} for {groups} group refreshes"
            )
        print(f"shard replay {label} " + json.dumps(dict(
            shards=out["shards"], launches=launches, group_refreshes=groups,
            **run_summary(out, wall),
        )), flush=True)
    one, one_launches = reports.pop("unsharded fused")
    want = {k: v for k, v in replay_report(one).items() if k != "shards"}
    for label, (out, launches) in reports.items():
        got = {k: v for k, v in replay_report(out).items() if k != "shards"}
        if got != want:
            diff = sorted(k for k in want if got.get(k) != want[k])
            raise AssertionError(f"replay {label}: report differs in {diff}")
        if launches["coactivation"] != one_launches["coactivation"]:
            raise AssertionError(f"replay {label}: co-activation launched {launches}")
    # the shards' inputs were made on their own streams: done before the
    # group phases read them on this one
    torch.cuda.synchronize()
    print("shard groups " + json.dumps(dict(
        fused_tick=[[list(shape), list(sync)] for shape, sync, *_ in
                    fused_groups.get("fused_tick", {})],
        **{name: [[list(shape), list(sync)] for shape, sync, *_ in by_key]
           for name, by_key in family_groups.items()},
    )), flush=True)


TRAIN_ARGS = ["--arch", "paper-gpt-125m", "--steps", "60", "--batch", "8",
              "--seq", "512", "--window", "20", "--log-every", "1000"]
#: --data-stall-ms of the stall run the prefetch hides (a stall every 10
#: steps); the checked stall run takes this many median steps of run (a)
TRAIN_HIDDEN_STALL_MS = 50.0
TRAIN_STALL_STEPS = 10
#: steps of the profiled run
TRAIN_PROFILE_STEPS = 20
#: card against CPU: one step of paper-gpt-125m at full width, 2 layers,
#: f32, on a batch of this shape
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_BATCH = (4, 256)


def train_run(torch, train, argv) -> tuple[dict, dict]:
    """`train.run` on the card, keeping its Monitor: the summary, and the
    step time, throughput, device-events ratio and peak memory."""
    from unittest import mock

    monitors = []

    class Kept(train.Monitor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            monitors.append(self)

    args = train.make_argparser().parse_args(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(train, "Monitor", Kept):
        summary = train.run(args)
    wall = time.perf_counter() - t0
    (mon,) = monitors
    walls = sorted(r.wall for r in mon.recorder.history)
    step_s = walls[len(walls) // 2]
    stats = dict(
        wall_s=wall, steps=len(walls), median_step_ms=step_s * 1e3,
        tokens_per_s=args.batch * args.seq / step_s,
        train_seconds=summary["train_seconds"],
        monitor_overhead=summary["monitor_overhead"],
        events_ready_ratio=mon.events.ready_ratio,
        events_attempts=mon.events.attempts,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        first_loss=summary["first_loss"], last_loss=summary["last_loss"],
        windows=[dict(routing=w["routing"], data_share=w["shares"][0],
                      shares=w["shares"]) for w in summary["windows"]],
        actions=[a["kind"] for a in summary["actions"]],
    )
    return summary, stats


def check_windows(summary, n: int) -> None:
    windows = summary["windows"]
    if len(windows) != n:
        raise AssertionError(f"{len(windows)} windows, not {n}: {windows}")
    for w in windows:
        if "frontier_accounting" not in w["labels"]:
            raise AssertionError(f"window {w['index']} labels {w['labels']}")
        if abs(sum(w["shares"]) - 1.0) > 0.02:
            raise AssertionError(f"window {w['index']} shares {w['shares']}")


def close_params(got, want, lr: float) -> tuple[int, int, float]:
    """Elements off by more than 1e-6, elements, the largest difference;
    every element must lie within 2 x lr."""
    off = total = 0
    worst = 0.0
    for name, w in want.items():
        d = (got[name].detach().cpu().double() - w.detach().double()).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 1e-6).sum())
        total += d.numel()
    if worst > 2 * lr:
        raise AssertionError(f"a parameter moved {worst} from the CPU's, over 2 x lr")
    return off, total, worst


def card_against_cpu(torch, np) -> dict:
    """One train step of paper-gpt-125m at full width (2 layers, f32) on
    the card and on the CPU from the same weights and batch, TF32 off:
    losses within rtol 1e-5, parameters as the CPU test holds them (99.9 %
    within 1e-6, all within 2 x lr); the bf16 card loss at step 0 within
    2e-2 relative of the f32 one."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed.sharding import BASELINE_PLAN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, lr_at

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, seq = TRAIN_CHECK_BATCH
    base = dataclasses.replace(
        get_config("paper-gpt-125m"), n_layers=TRAIN_CHECK_LAYERS,
        attn_q_chunk=seq, attn_kv_chunk=seq)
    f32 = dataclasses.replace(base, param_dtype="float32", compute_dtype="float32")
    host = SyntheticTokens(base.vocab_size, batch, seq, seed=1).batch_at(0)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1)  # the CPU test's
    lr = float(lr_at(opt, torch.zeros(())))
    out = {}
    for name, cfg, devices in (("f32", f32, ("cuda", "cpu")), ("bf16", base, ("cuda",))):
        model = build_model(cfg)
        step, _ = build_train_step(model, make_local_mesh(), BASELINE_PLAN, opt)
        for dev in devices:
            state = init_train_state(model, torch.Generator().manual_seed(0), dev)
            b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            state, metrics = step(state, b)
            out[(name, dev)] = (float(metrics["loss"]),
                                dict(state.params.named_parameters()))
    (card, card_p), (cpu, cpu_p) = out[("f32", "cuda")], out[("f32", "cpu")]
    bf16 = out[("bf16", "cuda")][0]
    if abs(card - cpu) > 1e-5 * abs(cpu):
        raise AssertionError(f"f32 loss on the card {card} vs the CPU {cpu}")
    off, total, worst = close_params(card_p, cpu_p, lr)
    if off > 0.001 * total:
        raise AssertionError(f"{off} of {total} parameter elements off by > 1e-6")
    if abs(bf16 - card) > 2e-2 * abs(card):
        raise AssertionError(f"bf16 loss {bf16} vs f32 {card}")
    return dict(loss_f32_cuda=card, loss_f32_cpu=cpu, loss_bf16_cuda=bf16,
                params_off_1e6=off, params=total, max_param_diff=worst, lr=lr)


def nccl_gather(torch, np) -> dict:
    """A one-rank NCCL group: `TorchDistTransport` gathers a window on
    cuda:0 unchanged; after the group is destroyed a gather raises
    nothing and falls back to the local-only parts."""
    import torch.distributed as dist

    from repro_torch.telemetry import TelemetryGather, TorchDistTransport

    path = os.path.join(ROOT, "build", f"nccl_init_{os.getpid()}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0, world_size=1)
    try:
        transport = TorchDistTransport()
        if transport.device != torch.device("cuda", 0):
            raise AssertionError(f"NCCL gather buffers on {transport.device}")
        local = np.random.default_rng(0).standard_normal((20, 6))
        res = TelemetryGather(transport, 0).gather_window(local)
        if not res.ok or res.window.shape != (20, 1, 6) or not np.array_equal(
            res.window[:, 0, :], local
        ):
            raise AssertionError(f"NCCL gather: ok={res.ok} error={res.error!r}")
    finally:
        dist.destroy_process_group()
        if os.path.exists(path):
            os.remove(path)
    # with the group gone the all_gather raises inside the transport,
    # which answers with the local-only parts (the very array it was
    # given): for one rank those are the whole group, so `ok` stays true
    parts = transport.allgather(0, local, 5.0)
    if len(parts) != 1 or parts[0] is not local:
        raise AssertionError("a gather after destroy did not fall back to local")
    after = TelemetryGather(transport, 0).gather_window(local)
    return dict(ok=res.ok, elapsed_s=res.elapsed_s, after_destroy_ok=after.ok,
                after_destroy_present=list(after.present_ranks))


def train_profile(torch, train) -> dict:
    """A short run of the driver under torch.profiler (device activity
    only): the card's busy time per step against the step's wall."""
    from torch.profiler import ProfilerActivity, profile

    argv = TRAIN_ARGS + ["--steps", str(TRAIN_PROFILE_STEPS), "--window",
                         str(TRAIN_PROFILE_STEPS), "--device", "cuda"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        summary = train.run(train.make_argparser().parse_args(argv))
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
    return dict(steps=TRAIN_PROFILE_STEPS, device_busy_s=busy_s,
                train_seconds=summary["train_seconds"],
                device_busy_share=busy_s / summary["train_seconds"],
                device_busy_ms_per_step=busy_s / TRAIN_PROFILE_STEPS * 1e3,
                kernel_launches_per_step=sum(r[2] for r in rows) / TRAIN_PROFILE_STEPS,
                top=[dict(name=k[:80], device_us=us, count=c) for us, k, c in rows[:8]])


def train_phase(torch, np, smi: str) -> tuple[int, dict]:
    """The training driver with the monitor on the card: (a) paper-gpt-125m
    at full width, bf16 with remat, and the same run profiled; (b) data
    stalls, one the prefetch hides and one it cannot; (c) one step on the
    card against the CPU; (d) the gather on NCCL.  Returns run (a)'s peak
    memory in bytes and its attention kernel launches, which must be
    there: the main path takes the kernel."""
    from repro_torch.kernels.attention import causal
    from repro_torch.launch import train

    for key in causal.launches:
        causal.launches[key] = 0
    summary, stats = train_run(torch, train, TRAIN_ARGS)
    attention_launches = dict(causal.launches)
    if not (attention_launches["forward"] > 0 and attention_launches["backward_dq"]
            == attention_launches["backward_dkv"] > 0):
        raise AssertionError(f"the train run's attention launches: {attention_launches}")
    stats["attention_launches"] = attention_launches
    check_windows(summary, 3)
    if not summary["last_loss"] < summary["first_loss"]:
        raise AssertionError(f"loss {summary['first_loss']} -> {summary['last_loss']}")
    if not stats["events_ready_ratio"] > 0:
        raise AssertionError(f"device events: ready_ratio {stats['events_ready_ratio']}")
    print("train " + json.dumps(dict(card=smi, **stats)), flush=True)
    print("train_profile " + json.dumps(train_profile(torch, train)), flush=True)
    # a stall shows only past what the prefetch holds: two queued batches
    # and the one in hand, ~3 steps
    long_stall = round(TRAIN_STALL_STEPS * stats["median_step_ms"])
    for stall in (TRAIN_HIDDEN_STALL_MS, long_stall):
        stalled, s_stats = train_run(
            torch, train, TRAIN_ARGS + ["--data-stall-ms", str(stall)])
        check_windows(stalled, 3)
        routed = any("data.next_wait" in w["routing"] for w in stalled["windows"])
        print("train_stall " + json.dumps(dict(
            stall_ms=stall, routed_to_data=routed, card=smi, **s_stats)), flush=True)
        if stall == long_stall and not routed:
            raise AssertionError(f"a {stall} ms stall every 10 steps routed no "
                                 f"window to data.next_wait: {stalled['windows']}")
    print("train_check " + json.dumps(card_against_cpu(torch, np)), flush=True)
    print("train_nccl " + json.dumps(nccl_gather(torch, np)), flush=True)
    return stats["max_memory_allocated"], attention_launches


#: the serve phase (a): the model serve driver at paper-gpt-125m's full
#: width and depth
SERVE_ARGS = ["--arch", "paper-gpt-125m", "--batch", "8", "--prompt-len", "128",
              "--decode", "128", "--window", "16"]
SERVE_PROFILE_STEPS = 32
#: full-depth serve runs of the other families: (arch, layers or None for
#: the config's own, batch, prompt, decode); phi3.5-moe's 32 layers need
#: ~84 GB in bf16, more than one card holds, so it is cut in depth only;
#: whisper-base serves the (a) run's shape, its encoder over seq / 4 = 64
#: frames
SERVE_FAMILY_RUNS = (
    ("mamba2-130m", None, 8, 32, 32),
    ("hymba-1.5b", None, 4, 16, 16),
    ("phi3.5-moe-42b-a6.6b", 2, 8, 16, 16),
    ("internvl2-1b", None, 8, 32, 32),
    ("whisper-base", None, 8, 128, 128),
)
#: teacher-forced decode on the card against the CPU, f32, TF32 off:
#: (arch, layers, batch, steps, cache layouts); hymba decodes past its
#: 1,024-token window; whisper-base keeps 2 encoder layers too
SERVE_CHECKS = (
    ("paper-gpt-125m", 2, 8, 64, ("bskd", "bksd")),
    ("mamba2-130m", 2, 8, 64, ("bskd",)),
    ("hymba-1.5b", 2, 2, 1040, ("bskd",)),
    ("phi3.5-moe-42b-a6.6b", 1, 8, 16, ("bskd",)),
    ("whisper-base", 2, 8, 64, ("bskd",)),
)
#: timed repetitions of the whisper encoder pass and cross-cache build
ENCODER_REPS = 20
#: card against CPU (atol and rtol), and the two cache layouts on the card
SERVE_TOL = 1e-4
LAYOUT_TOL = 1e-5


def serve_run(torch, serve, argv, cfg=None) -> tuple[dict, dict]:
    """`serve.run` on the card, keeping its Monitor (and serving `cfg`
    in place of the named config when given): the JSON, and the median
    decode step, wall, and peak memory (also less what was allocated
    before the run)."""
    from unittest import mock

    monitors = []

    class Kept(serve.Monitor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            monitors.append(self)

    args = serve.make_argparser().parse_args(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()  # what earlier phases still hold
    patches = [mock.patch.object(serve, "Monitor", Kept)]
    if cfg is not None:
        patches.append(mock.patch.object(serve, "get_config", lambda name: cfg))
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        out = serve.run(args)
    wall = time.perf_counter() - t0
    (mon,) = monitors
    walls = sorted(r.wall for r in mon.recorder.history[1:])  # decode steps
    if out["decoded"] != args.decode:
        raise AssertionError(f"{args.arch}: decoded {out['decoded']} of {args.decode}")
    peak = torch.cuda.max_memory_allocated()
    return out, dict(wall_s=wall, median_decode_step_ms=walls[len(walls) // 2] * 1e3,
                     max_memory_allocated=peak, peak_memory_of_run=peak - start)


def serve_profile(torch, arch: str = "paper-gpt-125m") -> dict:
    """`arch` at full width and depth (paper-gpt-125m, or whisper-base
    over zero frames): after a 128-token prompt, 32 greedy decode steps
    as the driver takes them (serve step, argmax, a wait on an event
    after it, the copy to the host) under torch.profiler (device
    activity): the card's busy share of their wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import DECODE_PLAN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import build_model

    batch, prompt = 8, 128
    seq = prompt + SERVE_PROFILE_STEPS
    model = build_model(get_config(arch))
    module = model.init(torch.Generator().manual_seed(0), "cuda")
    step, _ = build_serve_step(model, make_local_mesh(), DECODE_PLAN, seq)
    caches = model.init_caches(module, batch, seq)
    tokens = torch.randint(0, model.cfg.vocab_size, (batch, prompt),
                           generator=torch.Generator().manual_seed(0)).cuda()
    for i in range(prompt):
        logits, caches = step(module, caches, tokens[:, i:i + 1], i)
    tok = torch.argmax(logits[:, -1:, :], dim=-1)
    torch.cuda.synchronize()

    def decode(j):
        nonlocal tok, caches
        logits, caches = step(module, caches, tok, prompt + j)
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        tok[:, 0].cpu()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(SERVE_PROFILE_STEPS):
            decode(j)
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    n = SERVE_PROFILE_STEPS
    return dict(arch=arch, steps=n, wall_s=wall, device_busy_s=busy_s,
                device_busy_share=busy_s / wall, ms_per_step=wall / n * 1e3,
                device_busy_ms_per_step=busy_s / n * 1e3,
                kernel_launches_per_step=sum(r[2] for r in rows) / n,
                top=[dict(name=k[:80], device_us=us, count=c) for us, k, c in rows[:8]])


def teacher_forced(torch, model, module, tokens, seq: int, frames=None):
    """Logits [steps, B, Vpad] of `tokens` [steps, B, 1] fed one a step
    through `model.decode_step` on `module`'s device (after an encoder
    pass over `frames` for the encdec family)."""
    device = module.embed.device
    caches = model.init_caches(
        module, tokens.shape[1], seq,
        frames=None if frames is None else frames.to(device))
    tokens = tokens.to(device)
    out = torch.empty((tokens.shape[0], tokens.shape[1], model.cfg.padded_vocab),
                      dtype=torch.float32, device=module.embed.device)
    for i in range(tokens.shape[0]):
        logits, caches = model.decode_step(module, caches, tokens[i], i, seq)
        out[i] = logits[:, 0]
    return out.cpu()


def allclose_err(torch, got, want, tol: float) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| - tol - tol * |want|): the
    second is <= 0 when every element lies within atol = rtol = tol."""
    diff = (got.double() - want.double()).abs()
    return float(diff.max()), float((diff - tol - tol * want.double().abs()).max())


def serve_check(torch, arch: str, layers: int, batch: int, steps: int,
                layouts) -> dict:
    """`arch` at full width cut to `layers`, f32: teacher-forced decode on
    the card and on the CPU from the same weights (seed 0, drawn on the
    CPU) in each cache layout of `layouts`; logits within SERVE_TOL, two
    layouts on the card within LAYOUT_TOL; greedy agreement printed.  The
    encdec family keeps `layers` encoder layers too, decodes over random
    frames (seed 2), must agree on every greedy token, and holds its
    forward logits and loss within SERVE_TOL (`encdec_forward_check`)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    base = dataclasses.replace(get_config(arch), n_layers=layers,
                               param_dtype="float32", compute_dtype="float32")
    encdec = base.family == "encdec"
    frames = None
    if encdec:
        base = dataclasses.replace(base, n_enc_layers=layers)
        frames = torch.randn((batch, max(steps // base.enc_seq_divisor, 1), base.d_model),
                             generator=torch.Generator().manual_seed(2))
    tokens = torch.randint(0, base.vocab_size, (steps, batch, 1),
                           generator=torch.Generator().manual_seed(1))
    out = dict(arch=arch, layers=layers, batch=batch, steps=steps, dtype="float32",
               window=base.window if base.attention == "sliding" else None)
    if encdec:
        out.update(enc_layers=layers, frames=list(frames.shape))
    card_logits = {}
    for layout in layouts:
        model = build_model(dataclasses.replace(base, cache_layout=layout))
        cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        card = copy.deepcopy(cpu).cuda()
        t0 = time.perf_counter()
        got = teacher_forced(torch, model, card, tokens, steps, frames)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = teacher_forced(torch, model, cpu, tokens, steps, frames)
        cpu_s = time.perf_counter() - t0
        err, excess = allclose_err(torch, got, want, SERVE_TOL)
        if not (torch.isfinite(got).all() and excess <= 0):
            raise AssertionError(f"{arch} {layout}: card logits off the CPU's by {err}")
        out[layout] = dict(
            max_abs_err=err, card_s=card_s, cpu_s=cpu_s,
            greedy_agree=int((got.argmax(-1) == want.argmax(-1)).sum()),
            greedy_total=steps * batch)
        if encdec:
            if out[layout]["greedy_agree"] != steps * batch:
                raise AssertionError(f"{arch}: greedy tokens differ: {out[layout]}")
            out["forward"] = encdec_forward_check(torch, model, card, cpu, tokens, frames)
        card_logits[layout] = got
        del card, cpu
        torch.cuda.empty_cache()
    if len(card_logits) == 2:
        err, excess = allclose_err(torch, card_logits["bksd"], card_logits["bskd"], LAYOUT_TOL)
        if excess > 0:
            raise AssertionError(f"{arch}: bksd off bskd on the card by {err}")
        out["layouts_max_abs_err"] = err
    return out


def encdec_forward_check(torch, model, card, cpu, tokens, frames) -> dict:
    """The teacher-forced forward logits (no grad) and the loss (grad on,
    so each layer runs under its checkpoint) of `tokens` [steps, B, 1] as
    one [B, steps] batch over `frames`, random labels (seed 3), on the
    card and on the CPU: each within SERVE_TOL."""
    seq = tokens[:, :, 0].t().contiguous()
    labels = torch.randint(0, model.cfg.vocab_size, seq.shape,
                           generator=torch.Generator().manual_seed(3))
    batch = {"frames": frames, "tokens": seq, "labels": labels}
    on_card = {k: v.cuda() for k, v in batch.items()}
    with torch.no_grad():
        got, want = model.forward(card, on_card).cpu(), model.forward(cpu, batch)
    err, excess = allclose_err(torch, got, want, SERVE_TOL)
    if not (torch.isfinite(got).all() and excess <= 0):
        raise AssertionError(f"encdec forward: card logits off the CPU's by {err}")
    loss_card = float(model.loss(card, on_card).detach())
    loss_cpu = float(model.loss(cpu, batch).detach())
    loss_err, loss_excess = allclose_err(
        torch, torch.tensor([loss_card]), torch.tensor([loss_cpu]), SERVE_TOL)
    if not (math.isfinite(loss_card) and loss_excess <= 0):
        raise AssertionError(f"encdec loss: card {loss_card} against CPU {loss_cpu}")
    return dict(logits_max_abs_err=err, loss_card=loss_card, loss_cpu=loss_cpu,
                loss_abs_err=loss_err, remat=model.cfg.remat)


def encoder_timing(torch, batch: int, seq: int) -> dict:
    """whisper-base at full width and depth, bf16, seed-0 weights: the
    encoder pass over the serve run's zero frames, and the whole cross-
    cache build (`init_caches`: the encoder, each decoder layer's cross
    K/V and the zeroed self-attention caches), each timed with CUDA
    events over ENCODER_REPS calls after one warm-up; medians in ms."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import torch_dtype

    cfg = get_config("whisper-base")
    model = build_model(cfg)
    module = model.init(torch.Generator().manual_seed(0), "cuda")
    frames = torch.zeros((batch, max(seq // cfg.enc_seq_divisor, 1), cfg.d_model),
                         dtype=torch_dtype(cfg.compute_dtype), device="cuda")

    def median_ms(fn):
        fn()
        times = []
        for _ in range(ENCODER_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    with torch.inference_mode():
        encoder_ms = median_ms(lambda: module.encode(frames))
    caches_ms = median_ms(lambda: model.init_caches(module, batch, seq, frames=frames))
    return dict(frames=list(frames.shape), encoder_ms=encoder_ms,
                init_caches_ms=caches_ms, reps=ENCODER_REPS)


def serve_phase(torch, smi: str) -> None:
    """The model serve driver and the decode path on the card: (a)
    paper-gpt-125m at full width and depth, and 32 of its decode steps
    profiled; (c)–(g) the other families' serve runs (the encoder pass
    of (g) timed apart); (b)–(g) teacher-forced decode on the card
    against the CPU (and for (g) the forward and the loss)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import moe

    out, stats = serve_run(torch, serve, SERVE_ARGS)
    if not out["last_window_labels"] or not out["last_window_routing"]:
        raise AssertionError(f"serve windows: {out}")
    print("serve " + json.dumps(dict(card=smi, **out, **stats)), flush=True)
    print("serve_profile " + json.dumps(dict(card=smi, **serve_profile(torch))), flush=True)
    for arch, layers, batch, prompt, decode in SERVE_FAMILY_RUNS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        calls = []

        def count(module, inputs, _out):
            if isinstance(module, moe.MoE):
                calls.append(moe.dropped(module, inputs[0], module.cfg))

        with contextlib.ExitStack() as stack:
            if cfg.family == "moe":  # the serve driver builds its own model
                stack.callback(torch.nn.modules.module.register_module_forward_hook(
                    count).remove)
            run, stats = serve_run(torch, serve, [
                "--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
                "--decode", str(decode), "--window", "16"], cfg=cfg)
        if not run["last_window_labels"] or not run["last_window_routing"]:
            raise AssertionError(f"{arch} serve windows: {run}")
        line = dict(card=smi, layers=cfg.n_layers, prompt_len=prompt, **run, **stats)
        if cfg.family == "encdec":
            line.update(enc_layers=cfg.n_enc_layers,
                        **encoder_timing(torch, batch, prompt + decode))
            print("serve_profile " + json.dumps(dict(card=smi, **serve_profile(torch, arch))),
                  flush=True)
        if cfg.family == "moe":
            # one call a layer a step: the prompt's steps come first
            drops = [int(d) for d in calls]
            per_step = [sum(drops[i:i + layers]) for i in range(0, len(drops), layers)]
            decode_drops = per_step[prompt:]
            line.update(capacity=moe.capacity(batch, cfg), drops_prompt=sum(per_step[:prompt]),
                        drops_decode=sum(decode_drops),
                        decode_steps_with_drops=sum(d > 0 for d in decode_drops))
            if not any(decode_drops):
                raise AssertionError(f"{arch}: no decode step dropped at capacity")
        print("serve_family " + json.dumps(line), flush=True)
    for check in SERVE_CHECKS:
        print("serve_check " + json.dumps(dict(card=smi, **serve_check(torch, *check))),
              flush=True)


#: the examples phase: each example's argv after ``--device cuda`` (the
#: quickstart's 200 steps cut to 60, its checkpoints under build/)
EXAMPLE_ARGS = {
    "hidden_rank_demo": [],
    "whatif_demo": [],
    "fleet_monitor": [],
    "serve_demo": [],
    "quickstart": ["--steps", "60"],
}
#: launches each example must make: the what-if kernel once on the demo's
#: [20, 8, S] window; the fleet frontier kernel 1 + 4 times on the
#: [4, 10, 256, 6] window (`fleet_frontier_window`, `fleet_frontier_loop`)
EXAMPLE_LAUNCHES = {
    "whatif_demo": {"whatif_matrix": 1},
    "fleet_monitor": {"frontier_window": 5},
}


def examples_phase(torch, fused, kernels, coact, ex_fused, ex_families) -> None:
    """The five examples of the port (`repro_torch.examples`) on the card,
    each with its own asserts, the launch counts reset just before each
    and read just after: `fleet_monitor` must launch the fused tick (its
    service) and the frontier kernel 1 + 4 times, `whatif_demo` the
    what-if kernel once.  The inputs they hand the fused tick go into
    `ex_fused`, those they hand the single-family kernels into
    `ex_families`: the group phases hold each against its plain version."""
    import shutil
    from importlib import import_module

    ckpt = os.path.join(ROOT, "build", f"quickstart_{os.getpid()}")
    shutil.rmtree(ckpt, ignore_errors=True)
    for name, extra in EXAMPLE_ARGS.items():
        module = import_module(f"repro_torch.examples.{name}")
        argv = ["--device", "cuda", *extra]
        if name == "quickstart":
            argv += ["--ckpt-dir", ckpt]
        reset_launches(fused, kernels, coact)
        t0 = time.perf_counter()
        with recording_fused(fused, ex_fused), recording_families(kernels, ex_families):
            out = module.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(fused, kernels, coact)
        for kernel, n in EXAMPLE_LAUNCHES.get(name, {}).items():
            if launches[kernel] != n:
                raise AssertionError(f"{name}: {kernel} launched {launches[kernel]}, not {n}")
        if name == "fleet_monitor" and launches["fused_tick"] <= 0:
            raise AssertionError(f"fleet_monitor: the fused tick never launched: {launches}")
        if "OK" not in out["lines"][-1]:
            raise AssertionError(f"{name} ended in {out['lines'][-1]!r}")
        line = dict(wall_s=wall, launches=launches, last_line=out["lines"][-1])
        if name == "quickstart":
            s = out["summary"]
            line.update(steps=s["steps"], first_loss=s["first_loss"],
                        last_loss=s["last_loss"], monitor_overhead=s["monitor_overhead"])
        if name == "serve_demo":
            line.update(decoded=out["result"]["decoded"],
                        tokens_per_second=out["result"]["tokens_per_second"])
        print(f"example {name} " + json.dumps(line), flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)


#: the mesh phase: paper-gpt-125m at full width cut to this many layers,
#: f32, a batch of this shape, this many train and decode steps
MESH_LAYERS = 2
MESH_BATCH = (4, 256)
MESH_TRAIN_STEPS = 3
MESH_DECODE = (8, 16, 16)  # batch, prompt, decoded


def _plain_train_step(torch, model, opt):
    """The one-device train step written out (loss, autograd, AdamW): the
    plain version the mesh's step is held against."""
    from repro_torch.models.transformer import decay_mask
    from repro_torch.optim.adamw import apply_updates

    def step(state, batch):
        params = dict(state.params.named_parameters())
        loss = model.loss(state.params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt_state, om = apply_updates(opt, params, dict(zip(params, grads)),
                                         state.opt, decay_mask(state.params))
        state.opt, state.step = opt_state, state.step + 1
        return state, {"loss": loss.detach(), **om}

    return step


#: the mesh phase's Gloo cases, on CPU tensors under the card machine's
#: own torch: name -> (arch reduced, config changes, (data, model)).  The
#: MoE train step under BASELINE_PLAN on (2, 1): the experts' hidden dim
#: stored over `data`, gathered in each layer, its gradient
#: reduce-scattered.  The SSM prefill on (1, 2) with d_inner 192 in 6
#: heads of 32: the scan split over `model`, each rank computing its own
#: channels' projections (``in_proj``'s 422 columns split over the two
#: ranks: the weight gathered, no projection).
GLOO_CASES = {"moe-train": ("phi3.5-moe-42b-a6.6b", {}, (2, 1)),
              "ssm-prefill": ("mamba2-130m", {"ssm_expand": 3, "ssm_head_dim": 32}, (1, 2))}
GLOO_OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
#: loss and grad norm (rel), the prefill's logits (atol, rtol): the Gloo
#: cases of `tests/test_torch_sharding.py`
GLOO_TOL = (1e-5, (1e-5, 1e-5))
GLOO_RANK = r"""
import sys
import torch
import torch.distributed as dist
from repro_torch.distributed.sharding import BASELINE_PLAN
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import (
    build_prefill_step, build_train_step, init_train_state, shard_params, shard_train_state)
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig

rank, init, case_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
cases = torch.load(case_path, weights_only=False)
out = {}
case = cases["moe-train"]
model = build_model(case["cfg"])
step, state_sh = build_train_step(model, make_local_mesh(*case["mesh"], device="cpu"),
                                  BASELINE_PLAN, AdamWConfig(**case["opt"]))
state = init_train_state(model, device="cpu")
state.params.load_state_dict(case["params"])
state, m = step(shard_train_state(state, state_sh), case["batch"])
out["moe-train"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), params={
    n: p.full_tensor() for n, p in state.params.named_parameters()})
case = cases["ssm-prefill"]
model = build_model(case["cfg"])
prefill, param_sh = build_prefill_step(model, make_local_mesh(*case["mesh"], device="cpu"),
                                       BASELINE_PLAN)
module = model.init(device="cpu")
module.load_state_dict(case["params"])
out["ssm-prefill"] = dict(logits=prefill(shard_params(module, param_sh),
                                         {"tokens": case["batch"]["tokens"]}).full_tensor())
if rank == 0:
    torch.save(out, out_path)
dist.destroy_process_group()
"""


def gloo_cases(torch, np):
    """(the two Gloo ranks of `GLOO_CASES`, started; a function that
    waits for them and holds rank 0's results against the one-device
    steps, run here on the CPU meanwhile)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import BASELINE_PLAN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_prefill_step, build_train_step, init_train_state
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig

    folder = os.path.join(ROOT, "build", "gloo")
    os.makedirs(folder, exist_ok=True)
    for name in os.listdir(folder):
        os.remove(os.path.join(folder, name))
    rng = np.random.default_rng(5)
    cases = {}
    for name, (arch, changes, mesh) in GLOO_CASES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32))
                 for k in ("tokens", "labels")}
        batch["labels"][:2, :5] = -1
        params = build_model(cfg).init(generator=torch.Generator().manual_seed(0),
                                       device="cpu").state_dict()
        cases[name] = dict(cfg=cfg, mesh=mesh, opt=GLOO_OPT, params=params, batch=batch)
    case_path, out_path = os.path.join(folder, "cases.pt"), os.path.join(folder, "out.pt")
    torch.save(cases, case_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([os.environ["PYTHONPATH"]]
                                       if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_RANK, str(r), f"file://{folder}/init", case_path, out_path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for r in range(2)]

    def held() -> dict:
        try:
            one = {}
            case = cases["moe-train"]
            model = build_model(case["cfg"])
            step, _ = build_train_step(model, make_local_mesh(device="cpu"), BASELINE_PLAN,
                                       AdamWConfig(**case["opt"]))
            state = init_train_state(model, device="cpu")
            state.params.load_state_dict(case["params"])
            state, m = step(state, case["batch"])
            one["moe-train"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                    params=dict(state.params.named_parameters()))
            case = cases["ssm-prefill"]
            model = build_model(case["cfg"])
            prefill, _ = build_prefill_step(model, make_local_mesh(device="cpu"), BASELINE_PLAN)
            module = model.init(device="cpu")
            module.load_state_dict(case["params"])
            one["ssm-prefill"] = dict(logits=prefill(module, {"tokens": case["batch"]["tokens"]}))
            for p in procs:
                _, err = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise AssertionError(f"Gloo rank exited {p.returncode}: {err[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        got = torch.load(out_path, weights_only=False)
        rel, (atol, rtol) = GLOO_TOL
        lr = GLOO_OPT["peak_lr"]
        g, w = got["moe-train"], one["moe-train"]
        for key in ("loss", "grad_norm"):
            if abs(g[key] - w[key]) > rel * abs(w[key]):
                raise AssertionError(f"Gloo moe-train {key} {g[key]} vs one device {w[key]}")
        off, total, worst = close_params(g["params"], w["params"], lr)
        if off > 0.001 * total:
            raise AssertionError(f"Gloo moe-train: {off} of {total} elements off by > 1e-6")
        logits, want = got["ssm-prefill"]["logits"], one["ssm-prefill"]["logits"]
        err = float((logits - want).abs().max())
        if not torch.allclose(logits, want, atol=atol, rtol=rtol):
            raise AssertionError(f"Gloo ssm-prefill logits {err} from the one-device step's")
        return {"torch": torch.__version__, "seconds": time.perf_counter() - t0,
                "moe-train": dict(loss=g["loss"], grad_norm=g["grad_norm"],
                                  params_off=off, params_max_abs_err=worst),
                "ssm-prefill": dict(max_abs_err=err)}

    return held


def mesh_phase(torch, np) -> dict:
    """The mesh on the card: `make_local_mesh()` is one device of cuda:0
    with no process group; the train step built on it under BASELINE_PLAN
    and the serve step under DECODE_PLAN (paper-gpt-125m at full width, 2
    layers, f32) equal the plain steps bit for bit (loss, grad norm, every
    parameter and moment after each step; every decode step's logits and
    the caches); `compress_grads` on the card equals its CPU result on the
    same leaves bit for bit over three steps.  On one device no weight is
    split, so the tensor-parallel path (a context of None) is the plain
    code; the card holds one rank, so a tensor-parallel step's values are
    held on the CPU over Gloo ranks (`tests/test_torch_sharding.py`) and
    its counts here by the dryrun phase.  Two Gloo ranks on the CPU
    (`GLOO_CASES`: the MoE train step with its experts stored split over
    `data`, the split scan's prefill) under the card machine's own
    torch, held against the one-device steps (`gloo_cases`)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed import compress_grads, init_ef
    from repro_torch.distributed.sharding import BASELINE_PLAN, DECODE_PLAN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import (
        build_serve_step,
        build_train_step,
        init_train_state,
        shard_train_state,
    )
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig

    gloo = gloo_cases(torch, np)  # the CPU ranks run beside the card's cases
    mesh = make_local_mesh()
    if (mesh.size() != 1 or mesh.device_type != "cuda" or tuple(mesh.shape) != (1, 1)
            or dist.is_initialized()):
        raise AssertionError(f"make_local_mesh() gave {mesh} (group {dist.is_initialized()})")
    batch, seq = MESH_BATCH
    cfg = dataclasses.replace(
        get_config("paper-gpt-125m"), n_layers=MESH_LAYERS, param_dtype="float32",
        compute_dtype="float32", attn_q_chunk=seq, attn_kv_chunk=seq)
    model = build_model(cfg)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1)
    mesh_step, state_sh = build_train_step(model, mesh, BASELINE_PLAN, opt)
    runs = {}
    for label, step in (("mesh", mesh_step), ("plain", _plain_train_step(torch, model, opt))):
        state = init_train_state(model, torch.Generator().manual_seed(0), "cuda")
        if label == "mesh":
            state = shard_train_state(state, state_sh)
        losses = []
        for i in range(MESH_TRAIN_STEPS):
            host = SyntheticTokens(cfg.vocab_size, batch, seq, seed=1).batch_at(i)
            state, m = step(state, {k: torch.from_numpy(v).cuda() for k, v in host.items()})
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        runs[label] = (losses, state)
    (mesh_losses, mesh_state), (plain_losses, plain_state) = runs["mesh"], runs["plain"]
    if mesh_losses != plain_losses:
        raise AssertionError(f"mesh train step {mesh_losses} vs plain {plain_losses}")
    plain_params = dict(plain_state.params.named_parameters())
    for name, p in mesh_state.params.named_parameters():
        if not (torch.equal(p, plain_params[name])
                and torch.equal(mesh_state.opt.mu[name], plain_state.opt.mu[name])
                and torch.equal(mesh_state.opt.nu[name], plain_state.opt.nu[name])):
            raise AssertionError(f"mesh train step: {name} differs from the plain step")

    b, prompt, n = MESH_DECODE
    seq_len = prompt + n
    serve_step, _ = build_serve_step(model, mesh, DECODE_PLAN, seq_len)
    module = mesh_state.params
    tokens = torch.randint(0, cfg.vocab_size, (b, seq_len),
                           generator=torch.Generator().manual_seed(0)).cuda()
    caches = {"mesh": model.init_caches(module, b, seq_len),
              "plain": model.init_caches(module, b, seq_len)}
    for i in range(seq_len):
        got, caches["mesh"] = serve_step(module, caches["mesh"], tokens[:, i:i + 1], i)
        want, caches["plain"] = model.decode_step(module, caches["plain"],
                                                  tokens[:, i:i + 1], i, seq_len)
        if not torch.equal(got, want):
            raise AssertionError(f"mesh serve step {i}: logits differ from the plain step")
    for k in caches["plain"]:
        if not torch.equal(caches["mesh"][k], caches["plain"][k]):
            raise AssertionError(f"mesh serve step: cache {k} differs")

    split_errors = split_softmax_case(torch)
    tp_splits = tensor_parallel_split_cases(torch)

    rng = np.random.default_rng(7)
    leaves = {name: rng.standard_normal(tuple(p.shape)).astype(np.float32)
              for name, p in list(plain_params.items())[:6]}
    results = {}
    for dev in ("cuda", "cpu"):
        g = {k: torch.from_numpy(v).to(dev) for k, v in leaves.items()}
        ef = init_ef(g)
        out = []
        for i in range(3):
            deq, ef = compress_grads({k: v * (i + 1) for k, v in g.items()}, ef)
            out.append({k: (t.cpu(), ef.error[k].cpu()) for k, t in deq.items()})
        results[dev] = out
    for step_card, step_cpu in zip(results["cuda"], results["cpu"]):
        for k, (deq, err) in step_card.items():
            if not (torch.equal(deq, step_cpu[k][0]) and torch.equal(err, step_cpu[k][1])):
                raise AssertionError(f"compress_grads on the card: {k} differs from the CPU")
    gloo_results = gloo()
    print("mesh-gloo " + json.dumps(gloo_results), flush=True)
    return dict(mesh=str(mesh), mesh_shape=list(mesh.shape), layers=MESH_LAYERS,
                train_steps=MESH_TRAIN_STEPS, losses=mesh_losses,
                decode_steps=seq_len, split_softmax_max_abs_err=split_errors,
                tensor_parallel_splits=tp_splits,
                compress_leaves=len(leaves),
                compress_elements=sum(v.size for v in leaves.values()),
                moments_placements=sorted({str(sh.placements)
                                           for sh in state_sh.moments.values()}))


#: the mesh phase's split softmax: batch, cache positions, chunks (one a
#: rank of `model` in the production meshes), filled length; heads of
#: paper-gpt-125m; tolerances by dtype (atol, rtol)
SPLIT_CASE = (8, 32768, 16, 20000)
SPLIT_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (1e-2, 2**-7)}


def split_softmax_case(torch) -> dict:
    """`chunked_decode_attention` (the sequence-parallel decode's softmax,
    its chunks combined in one process) against `decode_attention` on
    the card: both layouts, both `cast_f32`, f32 and bf16 caches; each
    case's max abs error, held to `SPLIT_TOL`."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    cfg = get_config("paper-gpt-125m")
    b, positions, chunks, length = SPLIT_CASE
    g = torch.Generator(device="cuda").manual_seed(3)
    errors = {}
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        q = torch.randn((b, 1, cfg.n_heads, cfg.head_dim), generator=g, device="cuda").to(td)
        for layout, seq in (("bskd", 1), ("bksd", 2)):
            shape = ((b, positions, cfg.n_kv_heads, cfg.head_dim) if layout == "bskd"
                     else (b, cfg.n_kv_heads, positions, cfg.head_dim))
            k, v = (torch.randn(shape, generator=g, device="cuda").to(td) for _ in range(2))
            whole = attention.decode_attention if layout == "bskd" else \
                attention.decode_attention_bksd
            for cast_f32 in (True, False):
                got = attention.chunked_decode_attention(
                    q, k.chunk(chunks, seq), v.chunk(chunks, seq), length,
                    cast_f32=cast_f32, layout=layout)
                want = whole(q, k, v, length, cast_f32=cast_f32)
                atol, rtol = SPLIT_TOL[dtype]
                torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
                errors[f"{dtype}/{layout}/cast_f32={cast_f32}"] = float(
                    (got.float() - want.float()).abs().max())
    return errors


#: the mesh phase's tensor-parallel splits, in one process as 16 ranks of
#: `model` would compute them: mamba2-130m's SSD at full width (batch,
#: positions) in 16 slices of d_inner; the query split of causal
#: attention with whisper-base's heads (8 of 64, 8 KV) and llama4-scout's
#: (40 of 128, 8 KV), one row, and of whisper's bidirectional
#: cross-attention (32,768 queries over 8,192 frames); tolerances
#: (atol, rtol)
TP_PARTS = 16
SPLIT_SCAN_CASE = (2, 4096)
SPLIT_SCAN_TOL = (1e-5, 1e-5)
QUERY_SPLIT_CASES = {  # name: (heads, kv heads, head dim, query rows, key rows)
    "whisper-base causal": (8, 8, 64, 32768, None),
    "llama4-scout causal": (40, 8, 128, 32768, None),
    "whisper-base cross": (8, 8, 64, 32768, 8192),
}
QUERY_SPLIT_TOL = (1e-6, 1e-6)


def tensor_parallel_split_cases(torch) -> dict:
    """The train and prefill steps' splits over 16 ranks of `model`, each
    computed in one process on the card against the whole form, f32; the
    scan and the causal splits run the port's CUDA kernels on both sides
    (kernel against kernel: each kernel against its plain version is held
    in the ssd and attention phases and the card tests): `ssm.split_ssm`
    (the scan on each rank's 96 channels, the gated norm's sums of
    squares summed) against `apply_ssm`, within
    `SPLIT_SCAN_TOL`; `attention.query_split_attention` (16 ranks' query
    blocks, k and v whole) against `chunked_causal_attention` at
    ``q_chunk`` 1,024 (each rank two blocks in zigzag), with and without
    ``triangular``, and against `full_cross_attention`, within
    `QUERY_SPLIT_TOL`; each case's max abs error, whether it is bit for
    bit, and its seconds."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention, ssm

    out = {}
    g = torch.Generator(device="cuda").manual_seed(5)
    cfg = dataclasses.replace(get_config("mamba2-130m"), param_dtype="float32",
                              compute_dtype="float32")
    mixer = ssm.SSM(cfg, torch.float32, "cuda", torch.Generator().manual_seed(0))
    with torch.no_grad():
        h = cfg.ssm_n_heads
        mixer.A_log.copy_(torch.randn(h, generator=g, device="cuda") * 0.5)
        mixer.D.copy_(1 + 0.3 * torch.randn(h, generator=g, device="cuda"))
        mixer.dt_bias.copy_(torch.randn(h, generator=g, device="cuda") * 0.5)
        b, seq = SPLIT_SCAN_CASE
        x = torch.randn((b, seq, cfg.d_model), generator=g, device="cuda")
        t0 = time.perf_counter()
        whole = ssm.apply_ssm(mixer, x, cfg)
        got = ssm.split_ssm(mixer, x, cfg, TP_PARTS)
        torch.cuda.synchronize()
        atol, rtol = SPLIT_SCAN_TOL
        torch.testing.assert_close(got, whole, atol=atol, rtol=rtol)
        out[f"mamba2-130m ssd {b} x {seq}"] = dict(
            max_abs_err=float((got - whole).abs().max()), bitwise=torch.equal(got, whole),
            seconds=time.perf_counter() - t0)
        for name, (heads, kv, d, rows, keys) in QUERY_SPLIT_CASES.items():
            q = torch.randn((1, rows, heads, d), generator=g, device="cuda")
            k, v = (torch.randn((1, keys or rows, kv, d), generator=g, device="cuda")
                    for _ in range(2))
            for triangular in ((False,) if keys else (False, True)):
                if keys:
                    core, q_chunk = attention.full_cross_attention, None
                else:
                    def core(q_, k_, v_, q_blocks=None, q_chunk=1024, tri=triangular):
                        return attention.chunked_causal_attention(
                            q_, k_, v_, q_chunk=q_chunk, kv_chunk=1024, triangular=tri,
                            remat_qblock=False, q_blocks=q_blocks)
                    q_chunk = 1024
                t0 = time.perf_counter()
                whole = core(q, k, v)
                got = attention.query_split_attention(core, q, k, v, TP_PARTS, q_chunk)
                torch.cuda.synchronize()
                atol, rtol = QUERY_SPLIT_TOL
                torch.testing.assert_close(got, whole, atol=atol, rtol=rtol)
                label = name + (" triangular" if triangular else "")
                out[label] = dict(max_abs_err=float((got - whole).abs().max()),
                                  bitwise=torch.equal(got, whole),
                                  seconds=time.perf_counter() - t0)
                del whole, got
    return out


#: the dryrun phase: (arch, shape, mesh, flags), one CLI call each on the
#: card and on the CPU (the tests' cells, whisper-base and a skipped cell)
DRYRUN_CELLS = [
    ("qwen1.5-0.5b", "train_4k", "single", ["--accum", "1"]),
    ("mamba2-130m", "decode_32k", "both", []),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "single", []),
    ("whisper-base", "decode_32k", "single", []),
    ("paper-gpt-125m", "long_500k", "single", []),
    ("mamba2-130m", "prefill_32k", "single", []),
    ("whisper-base", "prefill_32k", "multi", []),
]
#: a row's wall-clock fields, the only ones a card row may differ in
DRYRUN_CLOCKS = ("compile_s", "delta_s", "wall_s")
#: the dryrun phase's phi3.5-moe train_4k on (16, 16) at full width cut
#: to this many layers (four microbatches): the experts gathered in each
#: layer, their gradients kept on their shards
DRYRUN_MOE_LAYERS = 2
DRYRUN_MOE_CELL = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.sharding import BASELINE_PLAN
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

layers, device = int(sys.argv[1]), sys.argv[2]
cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), n_layers=layers)
with dryrun.fake_group():
    got = dryrun.measure_cell(cfg, SHAPES["train_4k"], make_production_mesh(device_type=device),
                              BASELINE_PLAN, device, accum=dryrun.TRAIN_ACCUM)
print(json.dumps({"memory": got["memory"], "costs": dataclasses.asdict(got["costs"])}))
"""


def failed_rows(out_dir: str) -> dict:
    """The error and trace of every row under `out_dir` that is not `ok`
    or `skipped`."""
    bad = {}
    for folder, _, names in os.walk(out_dir):
        for name in names:
            with open(os.path.join(folder, name)) as f:
                row = json.load(f)
            if row.get("status") not in ("ok", "skipped"):
                bad[os.path.join(os.path.basename(folder), name)] = row.get("trace", row)
    return bad


def dryrun_phase(torch, train_peak: int) -> dict:
    """The dry run on the card: `DRYRUN_CELLS` on the card and on the CPU
    in subprocesses, rows equal outside `DRYRUN_CLOCKS`; one `run_cell`
    in process allocates nothing on the card and leaves no group; the
    train phase's own step dry-run on one device against its measured
    peak (`train_peak` bytes)."""
    import dataclasses
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed.sharding import BASELINE_PLAN
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    out_dir = os.path.join(ROOT, "build", "dryrun")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([os.environ["PYTHONPATH"]]
                                       if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--device", device,
         "--out", os.path.join(out_dir, device)] + flags,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for device in ("cuda", "cpu") for arch, shape, mesh, flags in DRYRUN_CELLS]
    moe = {device: subprocess.Popen(
        [sys.executable, "-c", DRYRUN_MOE_CELL, str(DRYRUN_MOE_LAYERS), device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for device in ("cuda", "cpu")}
    procs += list(moe.values())
    moe_rows = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:  # a failed cell's error is in its row
                raise AssertionError(f"dry run {p.args[3:11]} exited {p.returncode}: "
                                     f"{out[-1000:]} {err[-2000:]} {failed_rows(out_dir)}")
            for device, q in moe.items():
                if q is p:
                    moe_rows[device] = json.loads(out.splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    rows = {}
    for device in ("cuda", "cpu"):
        folder = os.path.join(out_dir, device)
        rows[device] = {}
        for name in sorted(os.listdir(folder)):
            with open(os.path.join(folder, name)) as f:
                rows[device][name] = {k: v for k, v in json.load(f).items()
                                      if k not in DRYRUN_CLOCKS}
    if sorted(rows["cuda"]) != sorted(rows["cpu"]) or len(rows["cuda"]) != 8:
        raise AssertionError(f"dry run rows: {sorted(rows['cuda'])} vs {sorted(rows['cpu'])}")
    for name, row in rows["cuda"].items():
        if row["status"] not in ("ok", "skipped"):
            raise AssertionError(f"dry run {name}: {row.get('error', row['status'])}")
        if row != rows["cpu"][name]:
            keys = sorted(k for k in row if row[k] != rows["cpu"][name].get(k))
            raise AssertionError(f"dry run {name}: card row differs from the CPU's in {keys}")

    if moe_rows["cuda"] != moe_rows["cpu"]:
        raise AssertionError(f"dry run phi3.5-moe train_4k at {DRYRUN_MOE_LAYERS} layers: "
                             f"card {moe_rows['cuda']} vs CPU {moe_rows['cpu']}")
    moe_costs = moe_rows["cuda"]["costs"]
    print("dryrun-moe-train " + json.dumps({
        "cell": f"phi3.5-moe-42b-a6.6b train_4k (16, 16), {DRYRUN_MOE_LAYERS} layers",
        "temp_bytes": moe_rows["cuda"]["memory"]["temp_bytes"],
        "all_gather_bytes": moe_costs["coll_by_kind"]["all-gather"],
        "reduce_scatter_bytes": moe_costs["coll_by_kind"]["reduce-scatter"],
        "flops_per_device": moe_costs["flops"]}), flush=True)

    before = torch.cuda.memory_allocated()
    cell = dryrun.run_cell("mamba2-130m", "decode_32k", "single", device="cuda")
    if torch.cuda.memory_allocated() != before or dist.is_initialized():
        raise AssertionError(f"run_cell: {torch.cuda.memory_allocated() - before} bytes "
                             f"on the card, group up {dist.is_initialized()}")
    if cell["status"] != "ok" or cell["n_chips"] != 256:
        raise AssertionError(f"run_cell: {cell}")

    # the train phase's own step (`TRAIN_ARGS`: the driver caps the chunks at --seq)
    batch, seq = int(TRAIN_ARGS[TRAIN_ARGS.index("--batch") + 1]), int(
        TRAIN_ARGS[TRAIN_ARGS.index("--seq") + 1])
    cfg = get_config("paper-gpt-125m")
    cfg = dataclasses.replace(cfg, attn_q_chunk=min(cfg.attn_q_chunk, seq),
                              attn_kv_chunk=min(cfg.attn_kv_chunk, seq))
    train = dryrun.measure_cell(cfg, ShapeConfig("train_phase", seq, batch, "train"),
                                make_local_mesh(device="cuda"), BASELINE_PLAN, "cuda")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("the one-device dry run allocated on the card")
    if train["memory"]["args_bytes"] > train_peak:
        raise AssertionError(f"dry run args_bytes {train['memory']['args_bytes']} over the "
                             f"train phase's peak {train_peak}")
    # the train cell's tensor-parallel counts: each rank computes on its
    # shards of the weights, so no whole weight is gathered
    qwen = rows["cuda"]["single__qwen1.5-0.5b__train_4k.json"]["costs"]
    print("dryrun-tensor-parallel " + json.dumps({
        "cell": "qwen1.5-0.5b train_4k (16, 16), one microbatch",
        "flops_per_device": qwen["flops"],
        "all_gather_bytes": qwen["coll_by_kind"]["all-gather"],
        "all_reduce_bytes": qwen["coll_by_kind"]["all-reduce"]}), flush=True)
    # the decode rows: each rank decodes its batch rows against its own
    # slices of the caches, on its shards of the weights
    print("dryrun-sequence-parallel " + json.dumps({
        name: {"flops_per_device": row["costs"]["flops"],
               "temp_bytes": row["memory"]["temp_bytes"],
               "all_gather_bytes": row["costs"]["coll_by_kind"]["all-gather"]}
        for name, row in rows["cuda"].items()
        if "decode_32k" in name and row["status"] == "ok"}), flush=True)
    # the prefill rows: mamba2's scan on each rank's slice of d_inner,
    # whisper's attention split over query blocks (one row a rank)
    print("dryrun-split-scan " + json.dumps({
        name: {"flops_per_device": row["costs"]["flops"],
               "temp_bytes": row["memory"]["temp_bytes"],
               "all_gather_bytes": row["costs"]["coll_by_kind"]["all-gather"]}
        for name, row in rows["cuda"].items() if "prefill_32k" in name}), flush=True)
    summary = {name: {k: row.get(k) for k in ("status", "n_chips", "plan", "accum")}
               | ({"flops": row["costs"]["flops"],
                   "coll_bytes": row["costs"]["coll_bytes"],
                   "args_bytes": row["memory"]["args_bytes"],
                   "temp_bytes": row["memory"]["temp_bytes"],
                   "total_per_device_gib": row["memory"]["total_per_device_gib"],
                   "dominant": row["roofline"]["dominant"]} if row["status"] == "ok" else {})
               for name, row in rows["cuda"].items()}
    train_step = dict(
        shape=[batch, seq], memory=train["memory"], measured_peak_bytes=train_peak,
        predicted_total_bytes=round(train["memory"]["total_per_device_gib"] * 2**30))
    return dict(wall_s=wall, rows=summary, moe_train=moe_rows["cuda"]["memory"],
                train_step=train_step)


def profile_phase(torch, serve_fleet, label, argv) -> None:
    """A service run once more under torch.profiler: device busy time by
    kernel, against the service's own tick time (obs)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = serve_fleet.run(serve_fleet.make_argparser().parse_args(
            argv + ["--device", "cuda"]
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
    print(f"profile {label} " + json.dumps(dict(
        device_busy_s=busy_s, service_tick_s=tick_s,
        device_busy_share_of_tick=busy_s / tick_s if tick_s else None,
        top=[dict(name=k[:80], device_us=us, count=c) for us, k, c in rows[:8]
             + [r for r in rows[8:] if "coact" in r[1] or "fused_tick" in r[1]]],
    )), flush=True)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def largest(rows) -> dict:
    """The case with the most window elements (the first of equals)."""
    return max(rows, key=lambda r: math.prod(r["shape"]))


def kernel_row(name, launches, rows, main_row):
    """One entry of the `kernels` line: the main path's launches, the
    largest error over every case, times at `main_row`, a shape the
    main path handed the kernel."""
    source, replaces = KERNELS[name]
    return {
        "name": name,
        "route": "cuda",
        "source": f"{CSRC}/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }


def main() -> int:
    global CASE_ERRORS
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--keep-going", action="store_true",
                        help="record a failed kernel measurement and go on; "
                             "exit non-zero at the end if any failed")
    started = time.perf_counter()
    if parser.parse_args().keep_going:
        CASE_ERRORS = (RuntimeError, AssertionError)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isfile(os.path.join(src, "repro_torch", "__init__.py")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, src)
    from repro_torch.kernels import _lib
    from repro_torch.kernels.attention import causal
    from repro_torch.kernels.frontier import fused, ops
    from repro_torch.kernels.frontier import frontier as kernels
    from repro_torch.kernels.frontier import incidents as coact
    from repro_torch.kernels.ssd import scan as ssd_scan
    from repro_torch.launch import replay, serve_fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # one nvcc per source and instance, all started together
    t0 = time.perf_counter()
    builds = {src: (src, ops.CSRC, ops.NVCC_FLAGS) for src, _ in KERNELS.values()}
    builds["causal_attention"] = ("causal_attention.cu", causal.CSRC,
                                  causal.library_flags(ATTENTION_HEAD_DIM, torch.bfloat16))
    for pn in ssd_scan.INSTANCES:
        builds[f"ssd_scan {pn}"] = ("ssd_scan.cu", ssd_scan.CSRC, ssd_scan.library_flags(*pn))
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda args: _lib.build(*args), builds.values())))
    print(f"build {[lib.name for lib in libs.values()]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    spills, exempt = [], []
    for label, lib in libs.items():
        kernel = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("ptxas " + line.strip(), flush=True)
            if "Compiling entry" in line:
                kernel = entry_kernel(line)
            spilled = re.search(r"\b(\d+) bytes spill stores", line)
            if spilled and int(spilled.group(1)) > 0:
                allowed = SPILL_EXEMPT.get((label, kernel), 0)
                (exempt if int(spilled.group(1)) <= allowed else spills).append(
                    f"{label} {kernel}: {line.strip()}")
    if exempt:
        print(f"ptxas spills exempt by SPILL_EXEMPT: {exempt}", flush=True)
    if spills:
        fail(f"ptxas spills: {spills}")

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB
    rows = kernel_phase(torch, np, fused, kernels, flush)
    attention_rows = attention_phase(torch, flush)
    ssd_row = ssd_phase(torch, flush)
    fused_groups = {}
    with recording_fused(fused, fused_groups):
        coact_launches, groups = fabric_phase(fused, kernels, coact, serve_fleet)
    with recording_fused(fused, fused_groups):
        launches = service_phase(fused, kernels, coact, serve_fleet)
    tick_launches, tick_groups = tick_phase(torch, np, fused, kernels, coact)
    replay_coact = []
    replay_launches, replay_groups = replay_phase(
        fused, kernels, coact, replay, fused_groups, replay_coact
    )
    shard_fused, shard_families = {}, {}
    shard_phase(torch, np, fused, kernels, coact, serve_fleet, replay,
                shard_fused, shard_families)
    coact_rows = coact_phase(torch, np, coact, groups, replay_coact, flush)
    # each kernel at the inputs its main path handed it
    fused_rows = fused_group_phase(torch, fused, "main-path", fused_groups, flush)
    tick_rows = group_phase(torch, kernels, "tick", tick_groups, flush)
    replay_rows = group_phase(torch, kernels, "replay", replay_groups, flush)
    # ... and at every group the sharded runs and the J case handed it
    shard_fused_rows = fused_group_phase(torch, fused, "shard", shard_fused, flush)
    shard_rows = group_phase(torch, kernels, "shard", shard_families, flush)
    for name in ("fused_tick", *FOUR_DISPATCH):
        if not (shard_fused_rows if name == "fused_tick" else shard_rows.get(name)):
            raise AssertionError(f"the shard phase handed {name} no group")
    profile_phase(torch, serve_fleet, "service", SERVICE_ARGS)
    profile_phase(torch, serve_fleet, "fabric", FABRIC_ARGS)
    smi = card_name()
    train_peak, attention_launches = train_phase(torch, np, smi)
    serve_phase(torch, smi)
    ex_fused, ex_families = {}, {}
    examples_phase(torch, fused, kernels, coact, ex_fused, ex_families)
    # the examples' kernel inputs against the plain versions, bit for bit
    ex_fused_rows = fused_group_phase(torch, fused, "examples", ex_fused, flush)
    ex_rows = group_phase(torch, kernels, "examples", ex_families, flush)
    for name in ("frontier_window", "whatif_matrix"):
        if not ex_rows.get(name):
            raise AssertionError(f"the examples handed {name} no group")
    if not ex_fused_rows:
        raise AssertionError("the examples handed the fused tick no group")
    print("mesh " + json.dumps(dict(card=smi, **mesh_phase(torch, np))), flush=True)
    print("dryrun " + json.dumps(dict(card=smi, **dryrun_phase(torch, train_peak))),
          flush=True)
    if FAILURES:
        fail(f"{len(FAILURES)} kernel measurements failed: {FAILURES}")
    case_rows = {name: [r["four_dispatch"][name] for r in rows]
                 for name in FOUR_DISPATCH}
    print(f"elapsed {time.perf_counter() - started:.1f} s", flush=True)

    print(json.dumps({"kernels": [
        # the service's own DDP group shape; the fabric run's first group
        kernel_row("fused_tick", launches,
                   rows + fused_rows + shard_fused_rows + ex_fused_rows, rows[0]),
        kernel_row("coactivation", coact_launches, coact_rows, coact_rows[0]),
        # the frontier and what-if kernels: the four-dispatch replay's
        # launches, times at its largest group; the regime kernel: the
        # public four-dispatch tick's (the service never asks for regimes)
        *(kernel_row(name, replay_launches[name],
                     replay_rows[name] + case_rows[name] + shard_rows[name]
                     + ex_rows[name], largest(replay_rows[name]))
          for name in ("frontier_window", "whatif_matrix")),
        kernel_row("regime_stats", tick_launches["regime_stats"],
                   tick_rows["regime_stats"] + case_rows["regime_stats"]
                   + shard_rows["regime_stats"],
                   largest(tick_rows["regime_stats"])),
        # the train phase's launches; times at the 4k cell's layer
        dict(name="causal_attention", route="cuda",
             source="src/repro_torch/kernels/attention/csrc/causal_attention.cu",
             replaces="none: the JAX package leaves attention to XLA "
                      "(src/repro/models/attention.py)",
             launches=sum(attention_launches.values()),
             max_abs_err=max(r["max_abs_err"] for r in attention_rows),
             grad_max_abs_err=max(r["grad_max_abs_err"] for r in attention_rows),
             **{key: attention_rows[0][key] for key in (
                 "ms", "bwd_ms", "plain_ms", "plain_fwd_bwd_ms", "bound_ms", "bwd_bound_ms",
                 "bound_by", "library_ms", "library_fwd_bwd_ms")}),
        # the launches of the SSD phase's hymba train step; times at
        # hymba's layer
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd_scan.cu",
             replaces="none: the JAX package's `_ssd` is plain jnp "
                      "(src/repro/models/ssm.py)",
             launches=ssd_row["launches_fwd"] + ssd_row["launches_bwd"],
             **{key: ssd_row[key] for key in (
                 "max_abs_err", "grad_max_abs_err", "ms", "bwd_ms", "plain_ms",
                 "plain_fwd_bwd_ms", "bound_ms", "bwd_bound_ms", "bound_by")}),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
