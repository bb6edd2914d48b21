"""The port's five examples (`repro_torch.examples`) against the
reference's, on the CPU (``--device cpu``: the kernels' plain versions).

- `hidden_rank_demo` prints the reference example's lines, word for word;
- `whatif_demo`'s kernel-route matrix equals the reference's Pallas route
  (interpret mode) on the same window, within rtol 1e-5 / atol 1e-6
  (`test_torch_four_dispatch.py`'s tolerance for the family);
- `fleet_monitor`'s service summary routes and snapshots as the
  reference's `serve_fleet.run` at the same argv (`test_torch_fleet.py`'s
  comparison), and its fleet-window shares equal the reference's
  `fleet_frontier_window`;
- `serve_demo` and `quickstart` run at short step counts and keep their
  asserts;
- every example asked for CUDA without a card raises, in process and as
  ``python -m``.
"""
import contextlib
import importlib.util
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import frontier as ref_kernels  # noqa: E402
from repro.launch import serve_fleet as ref_serve_fleet  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    fleet_monitor,
    hidden_rank_demo,
    quickstart,
    serve_demo,
    whatif_demo,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = {
    "hidden_rank_demo": hidden_rank_demo,
    "whatif_demo": whatif_demo,
    "fleet_monitor": fleet_monitor,
    "serve_demo": serve_demo,
    "quickstart": quickstart,
}
CPU = ["--device", "cpu"]
RTOL = 1e-4


def _reference_lines(name: str) -> list[str]:
    """The reference example's printed lines (its `main`, in process)."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main()
    return buf.getvalue().splitlines()


def test_hidden_rank_demo_prints_the_reference_lines(capsys):
    out = hidden_rank_demo.main(CPU)
    printed = capsys.readouterr().out.splitlines()
    assert printed == out["lines"]
    assert printed == _reference_lines("hidden_rank_demo")
    assert out["routing"][0] == "data.next_wait"
    assert out["leader_rank"] == out["injected_rank"]


@pytest.fixture(scope="module")
def whatif():
    return whatif_demo.main(CPU)


def test_whatif_demo_kernel_route_equals_the_pallas_route(whatif):
    ref = ref_kernels.whatif_matrix(
        jnp.asarray(whatif["durations"], jnp.float32),
        sync_stages=whatif["sync_stages"])
    np.testing.assert_allclose(whatif["matrix"], np.asarray(ref.matrix),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(whatif["matrix"], whatif["numpy_matrix"],
                               rtol=1e-3, atol=2e-3)


def test_whatif_demo_localizes_and_prices_the_fault(whatif):
    (stage, rank, recovered), (truth_key, truth_s) = whatif["top"], whatif["truth"]
    assert (stage, rank) == truth_key and recovered >= 0.9 * truth_s
    assert whatif["lines"][-1] == "kernel route matches the NumPy engine — OK"


@pytest.fixture(scope="module")
def fleet():
    port = fleet_monitor.main(CPU)
    ref = ref_serve_fleet.run(
        ref_serve_fleet.make_argparser().parse_args(fleet_monitor.SERVE_ARGV))
    return port, ref


def test_fleet_monitor_routes_as_the_reference(fleet):
    port, ref = fleet
    want, got = ref["routing"], port["summary"]["routing"]
    key = ("job", "stage", "rank", "regime", "persistence", "onset_step")
    assert [tuple(r[k] for k in key) for r in got] == [
        tuple(r[k] for k in key) for r in want]
    for g, w in zip(got, want):
        assert g["recoverable_s"] == pytest.approx(w["recoverable_s"], rel=RTOL)
    assert port["summary"]["snapshot"] == ref["snapshot"]
    assert port["summary"]["wire_bytes_per_packet"] == ref["wire_bytes_per_packet"]
    assert port["lines"][-1] == "OK: fleet service + streaming engine + fused fleet kernel"


def test_fleet_monitor_shares_equal_the_reference_window(fleet):
    port, _ = fleet
    ref = ref_kernels.fleet_frontier_window(jnp.asarray(fleet_monitor.fleet_window()))
    np.testing.assert_allclose(port["shares"], np.asarray(ref.shares),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port["loop_shares"], port["shares"], rtol=1e-4, atol=1e-5)


def test_serve_demo_decodes_24_tokens(capsys):
    out = serve_demo.main(CPU)
    assert out["result"]["decoded"] == 24
    assert out["lines"][0:2] == ["", "=== serve demo summary ==="]
    assert out["lines"][-1] == "OK"
    assert out["result"]["last_window_labels"]


def test_quickstart_trains_and_improves(tmp_path):
    out = quickstart.main(CPU + ["--steps", "30", "--window", "10",
                                 "--ckpt-dir", str(tmp_path / "ckpt")])
    summary = out["summary"]
    assert summary["steps"] == 30
    assert summary["last_loss"] < summary["first_loss"]
    assert len(summary["windows"]) == 3
    assert out["lines"][-1] == "OK"
    assert any(line.startswith("window 0: routing=") for line in out["lines"])


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_without_a_card_raise(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EXAMPLES[name].main([])


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_as_modules_without_a_card_raise(name):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert "OK" not in proc.stdout
