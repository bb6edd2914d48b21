"""Batched serving driver: prompt feed + token-by-token decode with monitoring.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch paper-gpt-125m --reduced --batch 4 --prompt-len 32 --decode 32

Runs on CUDA unless ``--device cpu``; without a card it raises.
Serving taxonomy: request.wait / prefill / decode.dispatch /
decode.device_wait / callbacks / residual — the same ordered-stage
contract as training (schemas are data, not code).  On the card each
stage times what its name says:
- ``decode.dispatch_cpu_wall`` only enqueues the serve step;
- ``decode.device_wait_cpu_wall`` enqueues the greedy argmax and waits on
  an event recorded after it (not on the whole device);
- ``callbacks.cpu_wall`` copies the tokens to the host.

Weights come from `model.init` with a seeded generator and the prompts
from another, both drawn on the CPU, so one seed gives the same weights
and prompts on the card and on the CPU; `run` also takes them injected.

Under torchrun (``WORLD_SIZE`` > 1) each process joins the group (Gloo
on the CPU, NCCL on the cards, one card a local rank) and the serve step
runs on `make_local_mesh()` over it, as the reference's driver takes
every local device: the weights placed by `DECODE_PLAN`, the caches by
`cache_shardings_for` (made whole first, the encoder-decoder's from its
encoder pass, then placed), the prompts over the batch axes.  The
greedy argmax reads the logits' `full_tensor()` ([B, 1, V]).  Each rank
keeps its own monitor, as the reference's; rank 0 prints the summary:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..configs import ShapeConfig, get_config
from ..core.contract import StageSchema
from ..distributed.sharding import DECODE_PLAN
from ..models import build_model
from ..models.transformer import torch_dtype
from ..telemetry.collector import Monitor
from .mesh import make_local_mesh
from .steps import build_serve_step, cache_shardings_for, shard_params

SERVE_STAGES = (
    "request.wait",
    "prefill.cpu_wall",
    "decode.dispatch_cpu_wall",
    "decode.device_wait_cpu_wall",
    "callbacks.cpu_wall",
    "step.other_cpu_wall",
)


def make_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="paper-gpt-125m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--decode", type=int, default=32)
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs without a card")
    return p


def _wait(tok: torch.Tensor) -> None:
    """Wait for `tok` alone: an event recorded after it on its stream."""
    if tok.is_cuda:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()


def _join_group(device: torch.device) -> tuple[torch.device, bool]:
    """Join the process group torchrun describes, where it names more
    than one process and none is up: (this process's device, whether
    it joined)."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device, False
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device, True


def _greedy(logits) -> torch.Tensor:
    """The argmax token of each row's last position (the whole batch)."""
    if isinstance(logits, DTensor):
        logits = logits.full_tensor()
    return torch.argmax(logits[:, -1:, :], dim=-1)


def run(args, *, params: dict | None = None, prompts=None) -> dict:
    """Serve one synthetic batch.  `params` (a state dict, e.g. from
    `params_from_jax`) replaces the drawn weights and `prompts` ([batch,
    prompt_len] integers) the drawn prompts."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.launch.serve: CUDA was asked for but is not "
            "available (pass --device cpu to serve on the CPU)"
        )
    device, joined = _join_group(device)
    try:
        return _serve(args, device, params, prompts)
    finally:
        if joined:
            dist.destroy_process_group()


def _serve(args, device, params, prompts) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    seq_len = args.prompt_len + args.decode
    schema = StageSchema(SERVE_STAGES, world_size=1)
    monitor = Monitor(schema, window_steps=args.window, event_q=0.0)

    module = model.init(torch.Generator().manual_seed(0), device)
    if params is not None:
        module.load_state_dict(params)
    mesh = make_local_mesh(device=device)
    serve_step, param_sh = build_serve_step(model, mesh, DECODE_PLAN, seq_len)

    def init_caches():
        frames = None
        if cfg.family == "encdec":
            # the stub audio frontend's frames: zeros, as the reference's
            # driver; the encoder pass is charged to the prefill stage
            frames = torch.zeros(
                (args.batch, max(seq_len // cfg.enc_seq_divisor, 1), cfg.d_model),
                dtype=torch_dtype(cfg.compute_dtype), device=device)
        return model.init_caches(module, args.batch, seq_len, frames=frames)

    whole = None
    if mesh.size() > 1:  # made from the plain weights, placed in the prefill stage
        whole = init_caches()
        cache_sh = cache_shardings_for(
            mesh, DECODE_PLAN, model.cache_specs(ShapeConfig("serve", seq_len, args.batch,
                                                             "decode")),
            seq_dim=3 if cfg.cache_layout == "bksd" and cfg.family != "encdec" else 2)
    module = shard_params(module, param_sh)
    if prompts is None:
        prompts = torch.randint(
            0, cfg.vocab_size, (args.batch, args.prompt_len),
            generator=torch.Generator().manual_seed(0),
        )
    prompts = torch.as_tensor(prompts).to(device)
    tokens_out = []
    t0 = time.perf_counter()
    with monitor.step():
        with monitor.stage("request.wait"):
            pass  # synthetic batched request already materialized
        with monitor.stage("prefill.cpu_wall"):
            if whole is None:
                caches = init_caches()
            else:
                caches = {k: distribute_tensor(c, mesh, cache_sh[k].placements)
                          for k, c in whole.items()}
            # feed the prompt token-by-token (cache warmup)
            for i in range(args.prompt_len):
                logits, caches = serve_step(module, caches, prompts[:, i:i + 1], i)
    monitor.end_of_step()
    tok = _greedy(logits)
    for j in range(args.decode):
        with monitor.step():
            with monitor.stage("decode.dispatch_cpu_wall"):
                logits, caches = serve_step(module, caches, tok, args.prompt_len + j)
            with monitor.stage("decode.device_wait_cpu_wall"):
                tok = _greedy(logits)
                _wait(tok)
            with monitor.stage("callbacks.cpu_wall"):
                tokens_out.append(tok[:, 0].cpu().numpy())
        monitor.end_of_step()
    elapsed = time.perf_counter() - t0

    # the final partial window stays buffered inside the Monitor (only
    # full windows are gathered), so flush() alone would drop the labels
    # of the last window that actually closed — fall back to it.
    report = monitor.aggregator.flush() or monitor.aggregator.last_report()
    return {
        "arch": cfg.name,
        "batch": args.batch,
        "decoded": len(tokens_out),
        "tokens_per_second": args.batch * len(tokens_out) / elapsed,
        "last_window_labels": list(report.diagnosis.labels) if report else [],
        "last_window_routing": list(report.diagnosis.routing_stages) if report else [],
        "sample_output": [int(t[0]) for t in tokens_out[:8]],
    }


def main() -> None:
    args = make_argparser().parse_args()
    out = run(args)
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
