"""The comparison that decides ``correct``.

Numbers, each held to its limit in the cell's file (``limits``):

- ``loss_gap``: over the first steps (the cell's ``check_steps``), the
  largest |program loss - reference loss| / |reference loss|;
- ``grad_gap``: over the leaves, the largest gap between the norms of
  the first gradient as the optimizer took it (the program's: its first
  moment after one step over 1 - b1) and the reference's, over the
  reference's norm of that leaf or of the median leaf, the larger;
- ``change_gap``: the same of each leaf's change over the first steps,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone);
- ``share_gap``: the largest |share - reference share| of a stage over
  the monitor's windows;
- ``routing_miss``: windows whose routing set differs from the
  reference's, or that the monitor did not report.

A number with no limit, or no value, makes the run not correct.
"""
from __future__ import annotations

import math
import statistics

__all__ = ["judge", "train_numbers", "window_numbers"]

#: a leaf moves by round-off alone under this share of the median gradient
ROUND_OFF = 1e-3


def _leaf_gap(prog: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    floor = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in leaves)


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """`prog` and `ref`: ``{"losses", "first_grad", "change"}``."""
    pairs = list(zip(prog["losses"], ref["losses"]))
    if len(pairs) < len(ref["losses"]):
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf}
    loss = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf for p, r in pairs)
    grads = ref["first_grad"]
    median = statistics.median(grads.values())
    moving = [n for n, g in grads.items() if g >= ROUND_OFF * median]
    return {
        "loss_gap": loss,
        "grad_gap": _leaf_gap(prog["first_grad"], grads, grads),
        "change_gap": _leaf_gap(prog["change"], ref["change"], moving),
    }


def window_numbers(reports: list[dict], reference: list[dict]) -> dict[str, float]:
    """`reports`: the monitor's windows, ``{"index", "shares", "routing"}``;
    `reference`: `reference.frontier.window_accounting` of the same steps
    (a window's index is its place there)."""
    share, miss = 0.0, 0
    seen = {r["index"] for r in reports}
    expected = set(range(len(reference)))
    if reports:
        expected = {i for i in expected if i >= min(seen)}
    miss += len(expected - seen)
    for r in reports:
        if r["index"] >= len(reference):
            miss += 1
            continue
        ref = reference[r["index"]]
        share = max([share] + [abs(a - b) for a, b in zip(r["shares"], ref["shares"])])
        miss += list(r["routing"]) != ref["routing"]
    return {"share_gap": share, "routing_miss": float(miss)}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, ``{name: {"value", "limit"}}``)."""
    table = {}
    correct = True
    for name, value in numbers.items():
        limit = limits.get(name)
        table[name] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            correct = False
    return correct, table
