"""The five readers of the program's device-timed regions, on made-up
records, and a traced tiny run that reports them."""
from __future__ import annotations

import types

import pytest

from stagebench import run, spec

from .conftest import BENCH

READERS = ("attention_ms.train", "mlp_ms.train", "head_loss_ms.train", "optimizer_ms.train",
           "recompute_ms.train")


def _record(sides):
    steps = [types.SimpleNamespace(durations={}, wall=1.0, side=side) for side in sides]
    return types.SimpleNamespace(step_records=steps)


def _read(name, record):
    return spec.load_reader(name, BENCH)(record)


STEP_A = {"region.embed.fwd": 0.001, "region.attention.fwd": 0.5,
          "region.attention.recompute": 0.75, "region.attention.bwd": 1.0,
          "region.mlp.fwd": 0.125, "region.mlp.recompute": 0.125, "region.mlp.bwd": 0.25,
          "region.head_loss.fwd": 0.0625, "region.head_loss.bwd": 0.0625,
          "region.optimizer": 0.25, "region.none": 0.01, "region.step": 3.136}
STEP_B = {"region.attention.fwd": 0.25, "region.attention.bwd": 0.5,
          "region.mlp.fwd": 0.25, "region.mlp.bwd": 0.5,
          "region.head_loss.fwd": 0.125, "region.head_loss.bwd": 0.125,
          "region.optimizer": 0.5, "region.step": 2.25}


@pytest.mark.parametrize("name,want", [
    ("attention_ms.train", 1e3 * (2.25 + 0.75) / 2),
    ("mlp_ms.train", 1e3 * (0.5 + 0.75) / 2),
    ("head_loss_ms.train", 1e3 * (0.125 + 0.25) / 2),
    ("optimizer_ms.train", 1e3 * (0.25 + 0.5) / 2),
    ("recompute_ms.train", 1e3 * (0.75 + 0.125) / 2),
])
def test_reader_sums_and_averages_over_the_steps_with_regions(name, want):
    """Each region's side values summed over its phases and over the
    steps that carry ``region.step``, over their count: a step without
    regions (the first, untraced here) neither adds nor counts."""
    record = _record([{"fwd_device_ms": 1.0}, STEP_A, STEP_B])
    assert _read(name, record) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_regions(name):
    """A window whose steps carry no regions (the untraced run, or a
    program without them) reads None, and so does an empty window."""
    assert _read(name, _record([{}, {"fwd_device_ms": 1.0}])) is None
    assert _read(name, _record([])) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_step_whose_side_settles_on_read(name):
    """The window's last step is folded only when its side channel is
    read (`repro_torch.telemetry.SideValues`): the readers read through
    the mapping, so they see it."""
    from repro_torch.telemetry import SideValues

    side = SideValues()
    side.settle = lambda: dict.update(side, STEP_B)
    assert _read(name, _record([side])) == _read(name, _record([dict(STEP_B)]))


def test_traced_tiny_run_reports_the_regions(tiny):
    """A traced run (a CPU profiler over the window) turns the program's
    regions on with no other call, reports all five metrics and comes
    out correct."""
    root, bench = tiny
    cell = spec.load_cell("tiny.dense", bench, root)
    traced = run.run_cell(cell, bench, 2**31 + 29, 0.5, True, "cpu", root=root)
    assert traced["correct"], traced["checks"]
    for name in READERS:
        assert traced["metrics"][name]["value"] > 0, name
        assert traced["metrics"][name]["unit"] == "ms"
