"""The FLOP counter against hand-worked counts."""
from __future__ import annotations

import json

import pytest

from stagebench import spec
from stagebench.flops import step_flops
from stagebench.flops.dense import parameters
from stagebench.reference.params import Arch


def _config(name):
    with open(spec.HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_parameter_counts_are_the_published_models():
    assert parameters(Arch.from_config(_config("granite-3-2b"))) == 2_533_787_648
    assert parameters(Arch.from_config(_config("hymba-1.5b"))) == 1_590_027_520


@pytest.mark.parametrize("batch, seq, expected", [
    # 6 x 2,533,787,648 x 16,384 + 6 x 40 x 2,048 x 4,096 x 4,097 / 2 x 2 x 4 (causal pairs)
    (4, 4096, 2.8207e14),
    (32, 512, 2.5321e14),
])
def test_dense_step(batch, seq, expected):
    flops = step_flops(_config("granite-3-2b"), batch, seq)
    assert flops == pytest.approx(expected, rel=1e-4)
    n = 2_533_787_648
    pairs = seq * (seq + 1) // 2
    assert flops == 6 * n * batch * seq + 12 * 2048 * pairs * 40 * batch


def test_hybrid_step():
    """6 N T, the 1,024 window's pairs (524,800 in the first window,
    1,024 for each of the 3,072 positions after), and the SSD's chunks."""
    flops = step_flops(_config("hymba-1.5b"), 4, 4096)
    n, q_dim, layers = 1_590_027_520, 25 * 64, 32
    pairs = 1024 * 1025 // 2 + 3072 * 1024
    chunk = 256 * 257 // 2 * (2 * 16 + 2 * 3200) + 4 * 256 * 16 * 3200
    assert flops == 6 * n * 16384 + 12 * q_dim * pairs * layers * 4 + 3 * chunk * 16 * layers * 4
    # the issue's rough figure, 6 N T plus attention at a few percent: ~1.62e14
    assert flops == pytest.approx(1.6695e14, rel=1e-4)
    assert flops == pytest.approx(1.62e14, rel=0.05)
