"""Nothing a run loads is JAX, flax or the JAX package (`repro`),
compared by whole top-level module name: the port, `repro_torch`,
begins with ``repro``."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from .conftest import BENCH

_PROBE = r"""
import sys
sys.path[:0] = [{src!r}, {checkout!r}, {tests!r}]
from pathlib import Path
import conftest as c
from stagebench import run, spec
root = Path({root!r})
bench = c.write_root(root, {{"tiny.hybrid": (c.tiny_config("hymba-1.5b"), c.TINY_TRAFFIC,
                                             c.TINY_SETTINGS)}})
result = run.run_cell(spec.load_cell("tiny.hybrid", bench, root), bench, 5, 0.3, True, "cpu",
                      root=root)
import stagebench.calibrate
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_run_loads_no_jax(tmp_path):
    checkout = BENCH.parent
    code = _PROBE.format(src=str(checkout / "src"), checkout=str(checkout),
                         tests=str(BENCH / "tests"), root=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "stagebench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_no_source_names_jax():
    """No file of the harness imports JAX or the JAX package."""
    for path in BENCH.rglob("*.py"):
        for line in Path(path).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in {"jax", "jaxlib", "flax", "repro"}, (path, line)
