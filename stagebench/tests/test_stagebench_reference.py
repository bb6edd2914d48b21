"""The plain reference against the port's plain path at a tiny size in
f32, on the same weights and batch: the loss, every gradient, and a
step of AdamW."""
from __future__ import annotations

import pytest
import torch

from stagebench.program import Program
from stagebench.reference.model import batch_loss
from stagebench.reference.params import Arch, param_layout
from stagebench.reference.precision import LINEAR
from stagebench.reference.train import train_readings
from stagebench.traffic import TokenStream
from stagebench.weights import make_weights

from .conftest import TINY_TRAFFIC, tiny_config


@pytest.mark.parametrize("name", ["granite-3-2b", "hymba-1.5b"])
def test_loss_and_gradients_match_the_port(name):
    config = tiny_config(name, "float32")
    program = Program(config, TINY_TRAFFIC, "cpu")
    state = program.load(3)
    batch = TokenStream(config["model"]["vocab_size"], TINY_TRAFFIC, 3).batch_at(0)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    params = dict(state.params.named_parameters())
    loss = program.model.loss(state.params, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    arch = Arch.from_config(config)
    ref = {n: w.float().requires_grad_(True)
           for n, w in make_weights(param_layout(arch), 3, "cpu").items()}
    ref_loss = batch_loss(arch, LINEAR["float32"], ref, batch["tokens"], batch["labels"])
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    for n, g in grads.items():
        scale = max(float(ref[n].grad.norm()), 1e-6)
        assert float((g - ref[n].grad).norm()) <= 1e-4 * scale, n


@pytest.mark.parametrize("name", ["granite-3-2b", "hymba-1.5b"])
def test_three_steps_match_the_port(name):
    """The port's train step three times in f32 against the reference's
    steps: losses, first gradients and changes agree to round-off."""
    from stagebench.check import train_numbers

    config = tiny_config(name, "float32")
    program = Program(config, TINY_TRAFFIC, "cpu")
    state = program.load(4)
    stream = TokenStream(config["model"]["vocab_size"], TINY_TRAFFIC, 4)
    batches = [stream.batch_at(i) for i in range(3)]
    start = program.snapshot()
    losses, first = [], None
    for i, b in enumerate(batches):
        state, metrics = program.step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = program.first_grad(state)
    prog = {"losses": losses, "first_grad": first, "change": program.change(start)}
    numbers = train_numbers(prog, train_readings(config, 4, batches, "cpu"))
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["grad_gap"] < 1e-4, numbers
    assert numbers["change_gap"] < 1e-3, numbers


def test_segment_sum_scan_matches_a_sequential_scan():
    """The reference's chunked SSD against the recurrence step by step."""
    from stagebench.reference.model import _ssd

    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 24, 3, 4, 5
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g) * 0.5
    a = -torch.rand(h, generator=g) * 2
    bb, cc = torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g)
    y = _ssd(x, dt, a, bb, cc, chunk=8)
    state = torch.zeros(b, h, p, n)
    for t in range(s):
        state = state * torch.exp(dt[:, t] * a)[..., None, None] \
            + (dt[:, t, :, None, None] * x[:, t, :, :, None] * bb[:, t, None, None, :])
        ref = torch.einsum("bhpn,bn->bhp", state, cc[:, t])
        assert torch.allclose(y[:, t], ref, atol=1e-5, rtol=1e-5)


def test_control_is_not_correct_at_test_size():
    """The control (the reference with fp8 products, in the program's
    place) reads above the tiny cell's limits; the program reads under."""
    from stagebench.check import train_numbers

    from .conftest import TINY_SETTINGS

    config = tiny_config("granite-3-2b")
    stream = TokenStream(config["model"]["vocab_size"], TINY_TRAFFIC, 6)
    batches = [stream.batch_at(i) for i in range(3)]
    ref = train_readings(config, 6, batches, "cpu")
    control = train_numbers(train_readings(config, 6, batches, "cpu", precision="fp8"), ref)
    limits = TINY_SETTINGS["limits"]
    assert any(control[k] > limits[k] for k in control), control


@pytest.mark.chip
def test_control_is_not_correct_at_cell_size():
    """On the card, at a cell's own size: the control fails the cell's
    limits on three seeds."""
    import json

    from stagebench import spec
    from stagebench.check import train_numbers

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(spec.HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    name = bench["workloads"][0]["name"]
    cell = spec.load_cell(name, bench)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        stream = TokenStream(cell.config["model"]["vocab_size"], cell.traffic, seed)
        batches = [stream.batch_at(i) for i in range(cell.settings["check_steps"])]
        ref = train_readings(cell.config, seed, batches, "cuda")
        control = train_numbers(
            train_readings(cell.config, seed, batches, "cuda", precision="fp8"), ref)
        limits = cell.settings["limits"]
        assert any(control[k] > limits[k] for k in control), (seed, control)
