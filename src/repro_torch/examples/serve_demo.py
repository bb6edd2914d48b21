"""Batched serving with StageFrontier monitoring (prefill + decode).

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--arch mamba2-130m] [--device cpu]

Serves a reduced model with batched requests through the KV-cache decode
path (`repro_torch.launch.serve` on ``--device``); the serving-taxonomy
monitor windows the request/prefill/decode stages under the same
ordered-stage contract as training.  Any further argument goes to the
serve driver after the demo's own (``--arch``, ``--decode``, ...).

The port's counterpart of `examples/serve_demo.py`: the same argv,
assert and printed lines.
"""
from __future__ import annotations

import sys

from ..launch import serve
from ._common import Lines

#: the demo's serve argv (before any of the caller's)
ARGV = ["--reduced", "--batch", "4", "--prompt-len", "16", "--decode", "24"]


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    # the driver takes --device (default cuda) and raises without a card
    result = serve.run(serve.make_argparser().parse_args(ARGV + argv))
    out = Lines()
    out("\n=== serve demo summary ===")
    for k, v in result.items():
        out(f"{k}: {v}")
    assert result["decoded"] == 24
    out("OK")
    return {"lines": out.lines, "result": result}


if __name__ == "__main__":
    main()
