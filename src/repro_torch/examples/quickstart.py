"""Quickstart: train a small LM with always-on StageFrontier monitoring.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--full] [--device cpu]

Trains the paper's evaluation-workload analogue (reduced unless --full,
the 125M configuration) for a few hundred steps with the full telemetry
pipeline (`repro_torch.launch.train` on ``--device``): ordered stage
recording, window gather, deterministic labeling, evidence packets, and
the router-to-profiler policy.  Prints per-window frontier shares and
labels.  Any further argument goes to the train driver after the
quickstart's own (``--steps 60``, ``--ckpt-dir DIR``, ...).

The port's counterpart of `examples/quickstart.py`, with its argv: it
checkpoints to ``stagefrontier_quickstart`` in the temporary directory
(`tempfile.gettempdir()`, ``/tmp`` by default) with ``--resume auto``.
Beware: a checkpoint left there by an earlier run at the last step
makes a rerun train 0 steps, and then the summary has no loss to print;
remove that directory (or pass another ``--ckpt-dir``) before a rerun.
"""
from __future__ import annotations

import os
import sys
import tempfile

from ..launch.train import make_argparser, run
from ._common import Lines


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    base = [
        "--arch", "paper-gpt-125m",
        "--steps", "200",
        "--batch", "8",
        "--seq", "128",
        "--window", "50",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), "stagefrontier_quickstart"),
        "--resume", "auto",
        "--log-every", "25",
    ]
    if "--full" not in argv:
        base.append("--reduced")
    # the driver takes --device (default cuda) and raises without a card
    summary = run(make_argparser().parse_args(base + [a for a in argv if a != "--full"]))
    out = Lines()
    out("\n=== StageFrontier quickstart summary ===")
    out(f"loss: {summary['first_loss']:.3f} -> {summary['last_loss']:.3f}")
    out(f"monitor overhead: {summary['monitor_overhead']*100:.4f}% of train time")
    for w in summary["windows"]:
        out(f"window {w['index']}: routing={w['routing'][:2]} labels={w['labels']}")
    assert summary["last_loss"] < summary["first_loss"], "training must improve"
    out("OK")
    return {"lines": out.lines, "summary": summary}


if __name__ == "__main__":
    main()
