"""hymba-1.5b's training path on the CPU: the SSD scan at the published
chunk of 256 (`models/ssm.py` `_ssd`), the port's hybrid train step
against the benchmark's plain f32 reference (`stagebench.reference`), and
the readers of the benchmark cell's SSD metrics.

The scan's decays are drawn as the benchmark draws them (Mamba-2's
initialisation): A = -U(1, 16) and dt = softplus(N(0, 1) + dt_bias), with
dt_bias the inverse softplus of a step log-uniform in [1e-3, 1e-1].  Over
a chunk of 256 tokens the segment sums then reach a few hundred, so
exp of an unmasked sum above the diagonal overflows.
"""
from __future__ import annotations

import math
import types

import pytest
import torch

from repro_torch.models import ssm

CHUNK = 256


def _scan_inputs(seed, s=512, h=4, hp=8, n=16):
    """(xh, dt, a, d, b, c) of `_ssd`, drawn as the benchmark's weights
    and a normed input make them; dt before the softplus is N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    a = -(1.0 + 15.0 * torch.rand(h, generator=g))
    u = torch.rand(h, generator=g)
    step = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = step + torch.log(-torch.expm1(-step))
    dt = torch.logaddexp(torch.randn(1, s, h, generator=g) + dt_bias, torch.zeros(()))
    return (torch.randn(1, s, h, hp, generator=g), dt, a, torch.ones(h),
            torch.randn(1, s, n, generator=g), torch.randn(1, s, n, generator=g))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssd_forward_and_every_gradient_are_finite_at_chunk_256(seed):
    """Masking the segment sums before the exp: the output and the
    gradient of each of the six inputs are finite, where exp before the
    mask gave an inf whose backward turned dt's and a's gradients into
    NaN."""
    inputs = [t.requires_grad_() for t in _scan_inputs(seed)]
    y = ssm._ssd(*inputs, CHUNK)
    grads = torch.autograd.grad(y.square().sum(), inputs)
    assert torch.isfinite(y).all()
    for name, g in zip(("xh", "dt", "a", "d", "b", "c"), grads):
        assert torch.isfinite(g).all(), name
        assert g.abs().max() > 0, name


@pytest.mark.parametrize("chunk", [64, CHUNK])
def test_ssd_equals_the_recurrence_token_by_token(chunk):
    """The chunked form (the state entering each chunk one product over
    the chunks' decays) against h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t,
    y_t = C_t h_t + D x_t, in f64 (atol 1e-10, rtol 1e-8: the two orders
    of f64 sums and exps)."""
    xh, dt, a, d, b_, c_ = (t.double() for t in _scan_inputs(3))
    y = ssm._ssd(xh, dt, a, d, b_, c_, chunk)
    state = torch.zeros(1, a.shape[0], xh.shape[-1], b_.shape[-1], dtype=torch.float64)
    want = []
    for t in range(xh.shape[1]):
        state = (state * torch.exp(dt[:, t] * a)[..., None, None]
                 + dt[:, t, :, None, None] * xh[:, t, :, :, None] * b_[:, t, None, None, :])
        want.append(torch.einsum("bhpn,bn->bhp", state, c_[:, t]) + d[:, None] * xh[:, t])
    torch.testing.assert_close(y, torch.stack(want, dim=1), atol=1e-10, rtol=1e-8)


# -- the hybrid train step against the benchmark's reference ---------------------------

#: two layers of hymba-1.5b at a CPU test's widths, the published chunk of
#: 256 over two chunks a row, and a window (64) shorter than the row
TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 128, "vocab_size": 256, "vocab_pad_multiple": 32, "window": 64,
        "ssm_state": 16, "ssm_head_dim": 16, "ssm_chunk": CHUNK,
        "param_dtype": "float32", "compute_dtype": "float32"}
TRAFFIC = {"name": "hymba-test", "loop": "closed", "batch": 2, "seq": 2 * CHUNK, "tilt": 3,
           "prefetch": 2, "stall_every": 0, "stall_ms": 0}


def _config():
    import json

    from stagebench.spec import HERE

    with open(HERE / "configs" / "hymba-1.5b.json") as f:
        config = json.load(f)
    config["model"].update(TINY)
    return config


@pytest.mark.parametrize("seed", [2**31 + 7, 2**31 + 8])
def test_hybrid_train_step_matches_the_reference(seed):
    """Three of the port's train steps in f32 from the benchmark's
    weights of `seed` against the reference's steps on the same batches
    (`stagebench.check.train_numbers`): the loss within 1e-5 of the
    reference's (f32 sums in another order over 1,024 tokens), each
    leaf's first gradient within 1e-4 of its norm or the median leaf's
    (the scan's exps of differences of cumulative sums, where the
    reference sums each segment apart), and each leaf's change over the
    three steps within 1e-3 (AdamW divides by the root of a second moment
    that one step leaves at g squared, so a leaf's change keeps its
    gradient's round-off, scaled up where that gradient is small)."""
    from stagebench.check import train_numbers
    from stagebench.program import Program
    from stagebench.reference.train import train_readings
    from stagebench.traffic import TokenStream

    config = _config()
    program = Program(config, TRAFFIC, "cpu")
    state = program.load(seed)
    stream = TokenStream(config["model"]["vocab_size"], TRAFFIC, seed)
    batches = [stream.batch_at(i) for i in range(3)]
    start = program.snapshot()
    losses = []
    for i, b in enumerate(batches):
        state, metrics = program.step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = program.first_grad(state)
    assert all(math.isfinite(x) for x in losses), losses
    prog = {"losses": losses, "first_grad": first, "change": program.change(start)}
    numbers = train_numbers(prog, train_readings(config, seed, batches, "cpu"))
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["grad_gap"] < 1e-4, numbers
    assert numbers["change_gap"] < 1e-3, numbers


# -- the cell's SSD metrics ----------------------------------------------------------------

#: a step of the program's regions (seconds), ``ssm_scan`` nested in ``ssm``
STEP = {"region.attention.fwd": 0.5, "region.ssm.fwd": 0.125, "region.ssm.recompute": 0.125,
        "region.ssm.bwd": 0.25, "region.ssm_scan.fwd": 0.25, "region.ssm_scan.recompute": 0.25,
        "region.ssm_scan.bwd": 0.5, "region.none": 0.0625, "region.step": 2.0625}


def _read(name, sides):
    from stagebench import spec

    steps = [types.SimpleNamespace(durations={}, wall=1.0, side=side) for side in sides]
    return spec.load_reader(name)(types.SimpleNamespace(step_records=steps))


@pytest.mark.parametrize("name,want", [("ssm_ms.train", 1e3 * 1.5),
                                       ("ssm_scan_ms.train", 1e3 * 1.0)])
def test_ssd_readers_sum_their_regions_over_the_steps_with_regions(name, want):
    """``ssm_ms.train``: ``ssm`` and the nested ``ssm_scan``, every phase;
    ``ssm_scan_ms.train``: the scan alone; a step without regions neither
    adds nor counts."""
    assert _read(name, [{}, STEP, STEP]) == pytest.approx(want, rel=1e-12)


def test_scan_reader_finds_nothing_where_the_scan_is_not_marked():
    """Regions off, or a program that marks ``ssm`` but not the scan
    inside it: the scan's metric reads None, the mixer's reads ``ssm``."""
    unmarked = {k: v for k, v in STEP.items() if not k.startswith("region.ssm_scan.")}
    assert _read("ssm_scan_ms.train", [unmarked]) is None
    assert _read("ssm_scan_ms.train", [{}, {"fwd_device_ms": 1.0}]) is None
    assert _read("ssm_ms.train", [unmarked]) == pytest.approx(500.0, rel=1e-12)
    assert _read("ssm_ms.train", [{}]) is None


#: a traced harness run of a tiny hybrid cell, in a fresh interpreter: the
#: harness refuses a run in a process that has loaded the JAX package,
#: as this test process has for the port's other tests
_TRACED_RUN = r"""
import json, sys
from pathlib import Path
from stagebench import run, spec
from stagebench.tests.conftest import TINY_SETTINGS, TINY_TRAFFIC, tiny_config, write_root

root = Path(sys.argv[1])
bench = write_root(root, {"tiny.hybrid": (tiny_config("hymba-1.5b"), TINY_TRAFFIC, TINY_SETTINGS)})
for metric in bench["per_layer"]:
    if metric["name"] in ("ssm_ms.train", "ssm_scan_ms.train"):
        metric["workloads"] = ["tiny.hybrid"]
cell = spec.load_cell("tiny.hybrid", bench, root)
result = run.run_cell(cell, bench, 2**31 + 31, 0.5, True, "cpu", root=root)
print(json.dumps({"correct": result["correct"], "checks": result["checks"],
                  "metrics": result["metrics"]}))
"""


def test_traced_tiny_hybrid_run_reports_the_ssd_metrics(tmp_path):
    """A traced harness run of a tiny hybrid cell turns the regions on and
    reports both SSD metrics, the scan a part of the mixer."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(root, "src"), root]))
    proc = subprocess.run([sys.executable, "-c", _TRACED_RUN, str(tmp_path)], cwd=root,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert traced["correct"], traced["checks"]
    whole = traced["metrics"]["ssm_ms.train"]["value"]
    scan = traced["metrics"]["ssm_scan_ms.train"]["value"]
    assert 0 < scan < whole
