"""The card's causal-attention kernel (`repro_torch.kernels.attention`)
and the plain version of its arithmetic.

On the CPU: the plain version (`causal_attention_ref`: the kernel's tile
walk, skips, three-part bf16 products and log-sum-exp backward) against
`chunked_causal_attention`'s plain walk and autograd, forward and all three
gradients; the split; the two walks of `triangular`; a CPU call builds
nothing; the refusals.  Marked ``card`` (skipped without a CUDA device): the kernel
against the plain version and the plain walk on the card, at the
benchmark cells' shapes and at every head size, dtype, window and query
split the port's configs reach; determinism; refusals; the launches of a
granite train step.  Run them on a card with
``python -m pytest -q -m card tests/test_torch_attention_kernel.py``.
"""
import ctypes
import dataclasses
import re
import types

import pytest
import torch

from repro_torch.kernels.attention import (
    HEAD_DIMS,
    causal_attention,
    causal_attention_ref,
    library_flags,
    split_parts,
)
from repro_torch.kernels import _lib
from repro_torch.kernels.attention import causal as kernel_module
from repro_torch.kernels.frontier import ops as frontier_ops
from repro_torch.models.attention import (
    chunked_causal_attention,
    chunked_causal_attention_plain,
    zigzag_blocks,
)


def _inputs(b, s, h, kv, d, dtype, device="cpu", sq=None, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    sq = s if sq is None else sq

    def draw(*shape, sd=1.0):
        return (torch.randn(shape, generator=g, device=device) * sd).to(dtype)

    # scores of a few units, as trained attention has, so the softmax is not flat
    return (draw(b, sq, h, d, sd=2.0), draw(b, s, kv, d, sd=2.0), draw(b, s, kv, d),
            draw(b, sq, h, d))


def _run(fn, q, k, v, dout):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    return (out, *torch.autograd.grad(out, (q, k, v), dout))


def _tolerance(dtype, scale):
    """(atol, rtol) between two computations of the same attention that
    differ only in the order of f32 sums (and, for f32 operands, in part
    products below f32 rounding).  A value within 1e-5 of the largest
    (`scale`): a key's gradient sums up to 16,384 rows' shares (4 x 4,096
    at the 4k cell) in another order, and where the sum cancels that is
    all of its error (at the 4k cell's shape in f32 on an H100 the kernel
    and the walk differ by 2e-6 to 3e-6 of it, as the plain version and
    the walk do).  Beyond it, f32 results 1e-5 relative, and bf16 results
    one bf16 rounding apart (2**-7 relative)."""
    return 1e-5 * scale, (1e-5 if dtype == torch.float32 else 2**-7)


def _walk_in_f32(fn, q, k, v, dout):
    """`fn`'s output and gradients taken in f32 on the same values, each
    rounded once to the inputs' dtype.  The plain walk in bf16 rounds each
    chunk's share of a gradient to bf16 (the backward of its `.float()`)
    and sums the shares in bf16; the kernel sums in f32 and rounds once,
    so its gradients are held against these."""
    got = _run(fn, q.float(), k.float(), v.float(), dout.float())
    return tuple(t.to(q.dtype) for t in got)


def _assert_same(got, want, dtype, what=""):
    names = ("out", "dq", "dk", "dv")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype == dtype, (name, a.dtype, b.dtype)
        scale = float(b.detach().float().abs().max())
        atol, rtol = _tolerance(dtype, scale)
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                                   msg=lambda m, n=name: f"{what} {n}: {m}")


# ---------------------------------------------------------------------------
# CPU: the plain version against the plain walk


@pytest.mark.parametrize("draw", ["normal", "wide", "probabilities"])
def test_split_parts_reconstruct_f32_exactly(draw):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=g)
    if draw == "wide":  # every exponent whose three parts are normal, both signs
        x = x.sign() * torch.exp2(torch.empty(4096).uniform_(-110, 126, generator=g)) * (1 + x.abs() % 1)
    elif draw == "probabilities":  # exp of scores far below the max, as P holds
        x = torch.exp(-torch.rand(4096, generator=g) * 70)
    hi, mid, lo = split_parts(x)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert torch.equal(hi + mid + lo, x)
    assert torch.equal(split_parts(x, 1)[0], x.to(torch.bfloat16).float())


#: (B, S, H, KV, D, window, q_blocks, q_chunk): GQA 1 and 4, a window, the
#: query split's zigzag blocks, head sizes 16 and 64, lengths no multiple
#: of the tiles
CPU_CASES = {
    "g1-d16": (2, 80, 2, 2, 16, None, None, 16),
    "g4-d16": (2, 96, 8, 2, 16, None, None, 32),
    "g4-d64": (1, 96, 8, 2, 64, None, None, 32),
    "g4-window": (2, 96, 8, 2, 16, 40, None, 32),
    "g1-window-d64": (1, 80, 2, 2, 64, 24, None, 16),
    "zigzag": (1, 128, 4, 1, 16, None, zigzag_blocks(8, 2)[1], 16),
    "zigzag-g4-window": (1, 128, 8, 2, 16, 36, zigzag_blocks(8, 4)[2], 16),
    "g8-d16": (1, 64, 8, 1, 16, None, None, 16),
    "g2-d16-batch3": (3, 112, 4, 2, 16, None, None, 16),
    "zigzag-g2-d64": (1, 128, 4, 2, 64, None, zigzag_blocks(4, 2)[0], 32),
    "zigzag-g1-window": (1, 128, 2, 2, 16, 20, zigzag_blocks(8, 2)[1], 16),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CPU_CASES))
def test_plain_version_matches_the_walk(case, dtype):
    b, s, h, kv, d, window, blocks, qc = CPU_CASES[case]
    sq = s if blocks is None else len(blocks) * qc
    q, k, v, dout = _inputs(b, s, h, kv, d, dtype, sq=sq, seed=len(case))
    kw = dict(window=window, q_blocks=blocks)

    def walk(*t):
        return chunked_causal_attention(*t, q_chunk=qc, kv_chunk=16, **kw)

    # small tiles, so the walk crosses many tile edges and skips
    got = _run(lambda *t: causal_attention_ref(*t, q_chunk=qc, block_m=16, block_n=16, **kw),
               q, k, v, dout)
    want = _run(walk, q, k, v, dout)[:1] + _walk_in_f32(walk, q, k, v, dout)[1:]
    _assert_same(got, want, dtype, case)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triangular_and_whole_walks_give_identical_values(dtype, window):
    """A key chunk outside a query chunk's sight adds exactly 0 to its sum
    and accumulator, so the kernel's skips change no value."""
    q, k, v, dout = _inputs(2, 96, 4, 2, 16, dtype, seed=5)
    runs = [_run(lambda q_, k_, v_, t=tri: chunked_causal_attention(
        q_, k_, v_, q_chunk=16, kv_chunk=16, window=window, triangular=t), q, k, v, dout)
        for tri in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1:], runs[1][1:]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_plain_version_tiles_change_no_value_beyond_f32_sums():
    q, k, v, dout = _inputs(1, 96, 8, 2, 16, torch.float32, seed=9)
    small = _run(lambda *t: causal_attention_ref(*t, block_m=16, block_n=16), q, k, v, dout)
    large = _run(lambda *t: causal_attention_ref(*t), q, k, v, dout)
    _assert_same(small, large, torch.float32, "tiles")


def test_cpu_call_builds_and_launches_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU call reached the CUDA build")

    monkeypatch.setattr(_lib, "nvcc_path", refuse)
    monkeypatch.setattr(_lib, "build", refuse)
    monkeypatch.setattr(_lib, "load_library", refuse)
    monkeypatch.setattr(_lib.subprocess, "run", refuse)
    monkeypatch.setattr(kernel_module, "launches", dict.fromkeys(kernel_module.launches, 0))
    q, k, v, dout = _inputs(1, 64, 4, 2, 16, torch.float32)
    _run(lambda *t: chunked_causal_attention(*t, q_chunk=16, kv_chunk=16), q, k, v, dout)
    with torch.no_grad():
        chunked_causal_attention(q, k, v, q_chunk=16, kv_chunk=16)
    assert set(kernel_module.launches.values()) == {0}


def test_kernel_refuses_cpu_tensors():
    q, k, v, _ = _inputs(1, 64, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        causal_attention(q, k, v)


@pytest.mark.parametrize("sq,q_blocks,q_chunk", [
    (48, None, 16),       # fewer query rows than keys, and no blocks
    (32, [0, 4], 16),     # block 4 ends past the 64 keys
    (32, [1], 16),        # one block of 16 rows for 32 query rows
    (32, [-1, 1], 16),
])
def test_kernel_refuses_rows_that_are_not_positions(sq, q_blocks, q_chunk):
    q, k, v, _ = _inputs(1, 64, 4, 2, 64, torch.bfloat16, sq=sq)
    with pytest.raises(ValueError, match="query rows"):
        kernel_module._spec(q, k, None, True, q_blocks, q_chunk)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_refuses_rounded_probabilities(dtype):
    """``cast_f32=False`` rounds P to bf16 before P.V on bf16 inputs: no
    configuration runs it on the card and the kernel has no instance for
    it, so it raises; on f32 inputs it rounds nothing and is taken."""
    q, k, v, _ = _inputs(1, 64, 4, 2, 64, dtype)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="cast_f32=False"):
            kernel_module._spec(q, k, None, False, None, 16)
    else:
        assert kernel_module._spec(q, k, None, False, None, 16) == \
            kernel_module._spec(q, k, None, True, None, 16)


def test_each_instance_builds_its_own_library_without_ftz(tmp_path, monkeypatch):
    monkeypatch.setattr(_lib, "build_dir", lambda: tmp_path)
    src = _lib.kernel_source("causal_attention.cu", kernel_module.CSRC)
    paths = {(d, dt): _lib._library_path(src, library_flags(d, dt))
             for d in HEAD_DIMS for dt in (torch.bfloat16, torch.float32)}
    assert len(set(paths.values())) == len(paths)
    for d, dt in paths:
        flags = library_flags(d, dt)
        assert "-ftz=true" not in flags and "arch=compute_90a,code=sm_90a" in flags
        assert f"-DHEAD_DIM={d}" in flags
    assert "-ftz=true" in frontier_ops.NVCC_FLAGS


def test_bind_declares_every_pointer_as_a_pointer():
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in (
        "causal_attention_forward", "causal_attention_dq", "causal_attention_dkv",
        "causal_attention_query_tile", "causal_attention_key_tile",
        "causal_attention_error_string")})
    kernel_module._bind(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i] * 7 + [f]
    assert lib.causal_attention_forward.argtypes == [p] * 7 + shape + [p]
    assert lib.causal_attention_dq.argtypes == [p] * 9 + shape + [p]
    assert lib.causal_attention_dkv.argtypes == [p] * 9 + shape + [p]


def test_the_source_uses_no_atomics_and_no_library_attention():
    text = _lib.kernel_source("causal_attention.cu", kernel_module.CSRC).read_text()
    assert not re.search(r"\batomic[A-Z]|\batom\.|\bred\.", text)
    for name in ("scaled_dot_product_attention", "cudnn", "flash_attn"):
        assert name not in text
    assert "-ftz=true" not in text.replace("WITHOUT -ftz=true", "")


# ---------------------------------------------------------------------------
# the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: (B, S, H, KV, D, dtype, window, q_blocks, q_chunk)
CARD_CASES = {
    # the benchmark cells' shapes (granite-3-2b)
    "b4s4096": (4, 4096, 32, 8, 64, torch.bfloat16, None, None, 1024),
    "b32s512": (32, 512, 32, 8, 64, torch.bfloat16, None, None, 512),
    # hymba-1.5b's cell: 25 heads over 5 KV heads, a 1,024-token window
    "hymba-b4s4096": (4, 4096, 25, 5, 64, torch.bfloat16, 1024, None, 1024),
    "d128": (2, 1024, 16, 4, 128, torch.bfloat16, None, None, 1024),
    "d256": (2, 512, 8, 2, 256, torch.bfloat16, None, None, 512),
    "window-g5": (2, 2048, 25, 5, 64, torch.bfloat16, 300, None, 1024),
    "f32": (2, 512, 8, 2, 64, torch.float32, None, None, 512),
    "f32-d128": (1, 320, 4, 1, 128, torch.float32, None, None, 320),
    "f32-d256": (1, 256, 4, 2, 256, torch.float32, 100, None, 256),
    "f32-d16-reduced": (2, 96, 4, 2, 16, torch.float32, 32, None, 32),
    "q-blocks": (2, 2048, 8, 2, 64, torch.bfloat16, None, [3, 0], 512),
    "q-blocks-f32-d128": (1, 1024, 10, 2, 128, torch.float32, None,
                          zigzag_blocks(8, 4)[1], 128),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_version_and_walk(card, case):
    b, s, h, kv, d, dtype, window, blocks, qc = CARD_CASES[case]
    sq = s if blocks is None else len(blocks) * qc
    q, k, v, dout = _inputs(b, s, h, kv, d, dtype, card, sq=sq, seed=len(case))
    kw = dict(window=window, q_blocks=blocks)
    got = _run(lambda *t: chunked_causal_attention(*t, q_chunk=qc, kv_chunk=qc, **kw),
               q, k, v, dout)
    mirror = _run(lambda *t: causal_attention_ref(*t, q_chunk=qc, **kw), q, k, v, dout)
    _assert_same(got, mirror, dtype, f"{case} against the plain version")
    del mirror

    def walk(*t):
        return chunked_causal_attention_plain(*t, q_chunk=qc, kv_chunk=qc, **kw)

    want = _run(walk, q, k, v, dout)[:1] + _walk_in_f32(walk, q, k, v, dout)[1:]
    _assert_same(got, want, dtype, f"{case} against the walk")


@pytest.mark.card
def test_kernel_is_deterministic(card):
    q, k, v, dout = _inputs(32, 512, 32, 8, 64, torch.bfloat16, card)
    fn = lambda *t: chunked_causal_attention(*t, q_chunk=512, kv_chunk=512)  # noqa: E731
    first, second = _run(fn, q, k, v, dout), _run(fn, q, k, v, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v, _ = _inputs(1, 128, 4, 2, 80, torch.bfloat16, card)
    with pytest.raises(ValueError, match="head_dim 80"):
        chunked_causal_attention(q, k, v, q_chunk=64, kv_chunk=64)
    q, k, v, _ = _inputs(1, 128, 4, 2, 64, torch.float16, card)
    with pytest.raises(ValueError, match="dtype"):
        chunked_causal_attention(q, k, v, q_chunk=64, kv_chunk=64)
    q, k, v, _ = _inputs(1, 128, 4, 2, 64, torch.bfloat16, card)
    with pytest.raises(ValueError, match="cast_f32=False"):
        chunked_causal_attention(q, k, v, q_chunk=64, kv_chunk=64, cast_f32=False)
    with pytest.raises(ValueError, match="not a CUDA device"):
        causal_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="query rows"):
        causal_attention(q[:, :64], k, v, q_blocks=[2], q_chunk=64)


@pytest.mark.card
def test_granite_train_step_takes_the_kernel(card, monkeypatch):
    """Two layers of granite-3-2b at full width, remat on: each layer's
    attention runs forward twice (the pass and the layer's recompute) and
    backward once (two launches); a no-grad forward launches once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import BASELINE_PLAN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2)
    assert cfg.remat and cfg.attn_remat and cfg.head_dim == 64
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), device="cuda")
    step, _ = build_train_step(model, make_local_mesh(device="cuda"), BASELINE_PLAN,
                               AdamWConfig())
    tokens = torch.randint(0, cfg.vocab_size, (2, 513), device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    monkeypatch.setattr(kernel_module, "launches", dict.fromkeys(kernel_module.launches, 0))
    state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    assert kernel_module.launches == {"forward": 4, "backward_dq": 2, "backward_dkv": 2}
    with torch.no_grad():
        model.forward(state.params, batch)
    assert kernel_module.launches["forward"] == 6


@pytest.mark.card
def test_hymba_train_step_takes_the_kernel(card, monkeypatch):
    """Two layers of hymba-1.5b at full width over 2 x 2,048 tokens (its
    1,024-token window and groups of 5 query heads a KV head), remat on:
    each layer's attention runs forward twice and backward once (two
    launches), as granite's, beside the SSD scan at its chunk of 256; the
    loss and every updated weight are finite."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import BASELINE_PLAN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=2)
    assert cfg.remat and cfg.attn_remat and cfg.head_dim == 64 and cfg.window == 1024
    assert cfg.ssm_chunk == 256
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), device="cuda")
    step, _ = build_train_step(model, make_local_mesh(device="cuda"), BASELINE_PLAN,
                               AdamWConfig())
    tokens = torch.randint(0, cfg.vocab_size, (2, 2049), device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    monkeypatch.setattr(kernel_module, "launches", dict.fromkeys(kernel_module.launches, 0))
    state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    for name, p in state.params.named_parameters():
        assert torch.isfinite(p).all(), name
    assert kernel_module.launches == {"forward": 4, "backward_dq": 2, "backward_dkv": 2}
    with torch.no_grad():
        model.forward(state.params, batch)
    assert kernel_module.launches["forward"] == 6
