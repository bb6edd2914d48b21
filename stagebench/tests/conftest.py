"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark's
layout (configurations, traffic, cells, metric readers) in a temporary
directory, run on the CPU.

The ``chip`` marker names a test that needs a CUDA card; such a test
decides inside itself whether one is there and skips without it.
"""
from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
CHECKOUT = BENCH.parent
for _p in (CHECKOUT / "src", CHECKOUT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


TINY_MODEL = {
    "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
    "d_ff": 128, "vocab_size": 256, "vocab_pad_multiple": 32,
}
TINY_HYBRID = dict(TINY_MODEL, window=32, ssm_state=16, ssm_head_dim=16, ssm_chunk=16)


def tiny_config(name: str, dtype: str = "bfloat16") -> dict:
    """The configuration `name` of the benchmark at a CPU test's size."""
    with open(BENCH / "configs" / f"{name}.json") as f:
        config = json.load(f)
    config = copy.deepcopy(config)
    config["model"].update(TINY_HYBRID if config["family"] == "hybrid" else TINY_MODEL)
    config["model"].update(param_dtype=dtype, compute_dtype=dtype)
    return config


def write_root(root: Path, cells: dict[str, tuple[dict, dict, dict]]) -> dict:
    """A benchmark layout under `root` with `cells` ({cell: (config,
    traffic, settings)}) and the real metric readers; returns its
    ``BENCHMARK.json`` object."""
    for kind in ("configs", "traffic", "workloads"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", root / "metrics", dirs_exist_ok=True)
    shutil.copy(BENCH / "peaks.json", root / "peaks.json")
    with open(CHECKOUT / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"], bench["workloads"] = [], []
    for cell, (config, traffic, settings) in cells.items():
        (root / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
        (root / "traffic" / f"{traffic['name']}.json").write_text(json.dumps(traffic))
        settings = dict(settings, name=cell, config=config["name"], traffic=traffic["name"],
                        chips=1)
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(settings))
        if not any(c["name"] == config["name"] for c in bench["configs"]):
            bench["configs"].append({"name": config["name"], "source": config["source"],
                                     "file": f"configs/{config['name']}.json",
                                     "reduced": [], "why": "test"})
        bench["workloads"].append({"name": cell, "config": config["name"],
                                   "traffic": traffic["name"], "chips": 1, "why": "test"})
    return bench


TINY_TRAFFIC = {"name": "tiny", "loop": "closed", "batch": 4, "seq": 64, "tilt": 3,
                "prefetch": 2, "stall_every": 0, "stall_ms": 0}
#: limits of the tiny cells, from their readings on the CPU over seeds
#: 100-111 (the bf16 program against the f32 reference: loss 4.8e-5,
#: gradient 8.6e-3, change 3.7e-2 at most) and the control's and half
#: batch's on seeds 100-102 (loss 2.5e-4 and 6.8e-4, gradient 1.3e-2 and
#: 8.7e-2 at least); a state left unchanged reads 1 on the change
TINY_SETTINGS = {"warmup_steps": 3, "check_steps": 3, "window_steps": 2,
                 "limits": {"loss_gap": 1.2e-4, "grad_gap": 0.04, "change_gap": 0.1,
                            "share_gap": 1e-9, "routing_miss": 0}}


@pytest.fixture
def tiny(tmp_path):
    """(root, BENCHMARK.json object) of one tiny dense cell ``tiny.dense``
    and one tiny hybrid cell ``tiny.hybrid``, bf16 as the real ones."""
    cells = {
        "tiny.dense": (tiny_config("granite-3-2b"), TINY_TRAFFIC, TINY_SETTINGS),
        "tiny.hybrid": (tiny_config("hymba-1.5b"), TINY_TRAFFIC, TINY_SETTINGS),
    }
    return tmp_path, write_root(tmp_path, cells)
