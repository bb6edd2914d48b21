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
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_config
from ..core.contract import StageSchema
from ..distributed.sharding import DECODE_PLAN
from ..models import build_model
from ..models.transformer import torch_dtype
from ..telemetry.collector import Monitor
from .mesh import make_local_mesh
from .steps import build_serve_step, shard_params

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
    serve_step, param_sh = build_serve_step(
        model, make_local_mesh(device=device), DECODE_PLAN, seq_len
    )
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
            frames = None
            if cfg.family == "encdec":
                # the stub audio frontend's frames: zeros, as the
                # reference's driver; the encoder pass is charged here
                frames = torch.zeros(
                    (args.batch, max(seq_len // cfg.enc_seq_divisor, 1), cfg.d_model),
                    dtype=torch_dtype(cfg.compute_dtype), device=device)
            caches = model.init_caches(module, args.batch, seq_len, frames=frames)
            # feed the prompt token-by-token (cache warmup)
            for i in range(args.prompt_len):
                logits, caches = serve_step(module, caches, prompts[:, i:i + 1], i)
    monitor.end_of_step()
    tok = torch.argmax(logits[:, -1:, :], dim=-1)
    for j in range(args.decode):
        with monitor.step():
            with monitor.stage("decode.dispatch_cpu_wall"):
                logits, caches = serve_step(module, caches, tok, args.prompt_len + j)
            with monitor.stage("decode.device_wait_cpu_wall"):
                tok = torch.argmax(logits[:, -1:, :], dim=-1)
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
    print(json.dumps(run(args), indent=2))


if __name__ == "__main__":
    main()
