"""The harness on the CPU at a tiny size: it finds a new cell,
configuration and metric by name, and a run with its timed path broken
comes out not correct."""
from __future__ import annotations

import json

import pytest
import torch

from stagebench import run, spec

from .conftest import TINY_SETTINGS, TINY_TRAFFIC, tiny_config, write_root

SEED = 2**31 + 11


def _run(root, bench, cell, trace=False, seconds=0.5):
    return run.run_cell(spec.load_cell(cell, bench, root), bench, SEED, seconds, trace,
                        "cpu", root=root)


@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.hybrid"])
def test_sound_run_is_correct(tiny, cell):
    root, bench = tiny
    result = _run(root, bench, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0


def test_new_cell_config_and_metric_need_no_edit(tmp_path):
    """A configuration, traffic mix, cell and per-layer metric added as
    files and entries alone are picked up."""
    config = tiny_config("granite-3-2b")
    config["name"] = "granite-tiny-extra"
    traffic = dict(TINY_TRAFFIC, name="extra", batch=2, seq=32)
    bench = write_root(tmp_path, {"extra.cell": (config, traffic, TINY_SETTINGS)})
    (tmp_path / "metrics" / "steps_seen.train.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "train_tokens_per_s",
                               "workloads": ["extra.cell"]})
    result = _run(tmp_path, bench, "extra.cell", trace=True)
    assert result["metrics"]["steps_seen.train"]["value"] == result["attempted"]
    assert result["correct"], result["checks"]
    json.dumps(result)


def _unchanged(build):
    def wrapped(model, *a, **k):
        step, sh = build(model, *a, **k)

        def train_step(state, batch):
            loss = model.loss(state.params, batch).detach()
            return state, {"loss": loss}
        return train_step, sh
    return wrapped


def _half_batch(build):
    def wrapped(model, *a, **k):
        step, sh = build(model, *a, **k)

        def train_step(state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(state, {n: v[:rows] for n, v in batch.items()})
        return train_step, sh
    return wrapped


def _altered_loss(build):
    def wrapped(model, *a, **k):
        step, sh = build(model, *a, **k)

        def train_step(state, batch):
            state, metrics = step(state, batch)
            return state, dict(metrics, loss=metrics["loss"] * 1.01)
        return train_step, sh
    return wrapped


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_loss",
                                   "altered_report", "altered_routing"])
@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.hybrid"])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    """Each fault a one-chip training cell can have, planted under the
    harness: the run comes out not correct."""
    from repro_torch.core import labeler, windows
    from repro_torch.core.routing import RoutingSet
    from repro_torch.launch import steps

    root, bench = tiny
    wraps = {"unchanged_state": _unchanged, "half_batch": _half_batch,
             "altered_loss": _altered_loss}
    if fault in wraps:
        monkeypatch.setattr(steps, "build_train_step", wraps[fault](steps.build_train_step))
    elif fault == "altered_report":
        close = windows.close_residual

        def altered(d, wall, schema):
            d = d.copy()
            d[0, 0, 0] += 1e-3
            return close(d, wall, schema)
        monkeypatch.setattr(windows, "close_residual", altered)
    else:
        candidates = labeler.candidate_set

        def widened(scores, tau=0.8):
            rs = candidates(scores, tau)
            extra = next(i for i in range(len(scores)) if i not in rs.stages)
            return RoutingSet(rs.stages + (extra,), rs.scores, rs.tau)
        monkeypatch.setattr(labeler, "candidate_set", widened)
    result = _run(root, bench, cell)
    assert not result["correct"], result["checks"]


def test_unknown_cell_is_refused(tiny):
    root, bench = tiny
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", bench, root)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types
    assert "repro_torch" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax", "repro"]


def test_no_card_exits_without_result():
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would proceed")
    proc = subprocess.run(
        [sys.executable, "stagebench/run.py", "--workload", "train.granite-3-2b.b4s4096",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=str(spec.HERE.parent), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""
