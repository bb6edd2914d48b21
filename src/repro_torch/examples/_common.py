"""What the examples share: the ``--device`` option and the printed lines."""
from __future__ import annotations

import argparse

from ..models.transformer import check_device


def parse(name: str, description: str, argv) -> argparse.Namespace:
    """Example `name`'s one argument, ``--device`` (default cuda, checked
    here: a missing card raises)."""
    p = argparse.ArgumentParser(prog=f"repro_torch.examples.{name}",
                                description=description)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs without a card")
    args = p.parse_args(argv)
    check_device(p.prog, args.device)
    return args


class Lines:
    """Prints each line and keeps it, for the summary `main` returns."""

    def __init__(self):
        self.lines: list[str] = []

    def __call__(self, text: str = "") -> None:
        print(text, flush=True)
        self.lines.extend(text.split("\n"))
