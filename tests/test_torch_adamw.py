"""The port's AdamW (`optim/adamw.py` `apply_updates`) over groups of
leaves against the loop over single leaves it replaced, written out
below: the same bits in every parameter and moment after each step, on
the CPU and (marked ``card``) on the card, for bf16 and f32 leaves,
with and without decay, a clipped norm, and leaves larger than a group.
Run the card case with
``python -m pytest -q -m card tests/test_torch_adamw.py``.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.optim.adamw import AdamWConfig, apply_updates, global_norm, init_opt, lr_at

CFG = AdamWConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=20)


def _per_leaf(cfg, params, grads, state, decay):
    """One AdamW step, a leaf at a time (the port's loop before groups)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = state.count + 1
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    lr = lr_at(cfg, state.count)
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = state.mu[n], state.nu[n]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decay[n]:
            step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    return state._replace(count=count)


def _tree(device, seed=0):
    """Leaves of a hybrid layer's kinds and dtypes; ``embed`` is the
    largest, so it sets the group size and stands alone."""
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = {"embed": ((96, 32), torch.bfloat16), "attn.wq": ((32, 32), torch.bfloat16),
              "ssm.A_log": ((8,), torch.float32), "ssm.D": ((8,), torch.float32),
              "attn_norm.scale": ((32,), torch.bfloat16), "mlp.wo": ((64, 32), torch.bfloat16),
              "mlp.wi": ((32, 64), torch.bfloat16), "ssm.dt_bias": ((8,), torch.float32),
              "ssm.conv_w": ((4, 48), torch.bfloat16)}
    return {n: torch.randn(s, generator=g, device=device).to(d) for n, (s, d) in shapes.items()}


def _grads(params, device, step, big):
    g = torch.Generator(device=device).manual_seed(100 + step)
    # a large gradient on the first step, so the clip scales it
    return {n: (torch.randn(p.shape, generator=g, device=device) * (50.0 if big else 1.0))
            .to(p.dtype) for n, p in params.items()}


def _same_bits_over_steps(device):
    ours, theirs = _tree(device), _tree(device)
    decay = {n: p.dim() >= 2 for n, p in ours.items()}
    s_ours, s_theirs = init_opt(ours), init_opt(theirs)
    for step in range(4):
        grads = _grads(ours, device, step, big=step == 0)
        _, s_ours, _ = apply_updates(CFG, ours, grads, s_ours, decay)
        s_theirs = _per_leaf(CFG, theirs, grads, s_theirs, decay)
        for n in ours:
            assert torch.equal(ours[n], theirs[n]), (step, n)
            assert torch.equal(s_ours.mu[n], s_theirs.mu[n]), (step, n)
            assert torch.equal(s_ours.nu[n], s_theirs.nu[n]), (step, n)
        assert int(s_ours.count) == int(s_theirs.count) == step + 1


def test_groups_give_the_per_leaf_loops_bits_on_the_cpu():
    _same_bits_over_steps("cpu")


@pytest.mark.card
def test_groups_give_the_per_leaf_loops_bits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's multi-tensor kernels")
    _same_bits_over_steps("cuda")


def test_groups_keep_decay_apart_and_hold_at_most_the_largest_leaf():
    from repro_torch.optim.adamw import _groups

    params = _tree("cpu")
    decay = {n: p.dim() >= 2 for n, p in params.items()}
    groups = _groups(params, decay)
    assert [n for grp in groups for n in grp] == list(params)
    cap = max(p.numel() for p in params.values())
    for grp in groups:
        assert len({decay[n] for n in grp}) == 1, grp
        assert len(grp) == 1 or sum(params[n].numel() for n in grp) <= cap, grp
    assert ["embed"] in groups
