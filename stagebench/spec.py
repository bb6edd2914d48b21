"""Finding a run's pieces by name.

A cell ``stagebench/workloads/<cell>.json`` names its configuration
(``configs/<config>.json``) and its traffic (``traffic/<traffic>.json``)
and holds its own settings (warm-up and checked steps, the monitor's
window, the limits of the check).  A metric named in ``BENCHMARK.json``
is read by ``metrics/<metric>.py``.  Adding a configuration, a traffic
mix, a cell or a metric is adding these files and their entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "Cell", "load_cell", "load_reader", "metrics_for"]

HERE = Path(__file__).resolve().parent


def _load(root: Path, kind: str, name: str) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    settings: dict


def load_cell(name: str, bench: dict, root: Path = HERE) -> Cell:
    """The cell `name` of `bench` (``BENCHMARK.json``'s content), its
    files under `root`; raises where they disagree with `bench`."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    settings = _load(root, "workloads", name)
    for key in ("config", "traffic", "chips"):
        if settings[key] != entry[key]:
            raise ValueError(f"{name}: {key} {settings[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    return Cell(name, _load(root, "configs", entry["config"]),
                _load(root, "traffic", entry["traffic"]), settings)


def metrics_for(bench: dict, cell: str, section: str) -> list[dict]:
    """The entries of `section` (``end_to_end`` or ``per_layer``) that
    `cell` reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def load_reader(metric: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "stagebench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
