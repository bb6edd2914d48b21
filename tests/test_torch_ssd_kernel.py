"""The card's SSD chunked scan (`repro_torch.kernels.ssd`) and the plain
version of its arithmetic.

On the CPU: the plain version (`ssd_scan_ref`: the kernels' chunk states,
state pass, tiles and hand-written backward) against autograd through
`models.ssm._ssd` in f64, output and the gradients of all six inputs, at
hymba-1.5b's (P 64, N 16, chunk 256), mamba2-130m's N of 128, the reduced
configs' (16, 16, chunk 16), head counts of 3 and 1 (the split scan's
slices) and chunks that fill no whole tile (100, 1: a prefill shorter than
the config's chunk); a CPU call builds and launches nothing; the refusals;
every chunk that divides the row is taken; the source
sums no gradient with atomics.  Marked ``card`` (skipped without a CUDA
device): the kernels against the plain `_ssd` on the card, each held to
f64, at hymba's layer shape, at every (P, N) the configs use and at
chunks of 100, 40 and 1; two runs
bit for bit; the refusals; the launches of a hymba train step.  Run them on
a card with ``python -m pytest -q -m card tests/test_torch_ssd_kernel.py``.

Inputs are drawn as ``tests/test_torch_hymba.py`` draws them (Mamba-2's
initialisation): A = -U(1, 16), dt = softplus(N(0, 1) + dt_bias) with
dt_bias the inverse softplus of a step log-uniform in [1e-3, 1e-1], so the
segment sums over a chunk of 256 reach a few hundred.
"""
import ctypes
import dataclasses
import importlib.util
import math
import pathlib
import re
import types

import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ssd import INSTANCES, library_flags, ssd_scan, ssd_scan_ref
from repro_torch.kernels.ssd import scan as kernel_module
from repro_torch.models import ssm

NAMES = ("y", "dxh", "ddt", "da", "dd", "db", "dc")


def _inputs(seed, b=1, s=512, h=4, hp=8, n=16, device="cpu", strided=False):
    """(xh, dt, a, d, b, c, dy) of `_ssd`; with `strided`, xh, b and c are
    column slices of one [B, S, H * P + 2N + 8] tensor, as `apply_ssm`
    passes the conv's output."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, rand=False):
        return (torch.rand if rand else torch.randn)(shape, generator=g, device=device)

    a = -(1.0 + 15.0 * draw(h, rand=True))
    step = torch.exp(math.log(1e-3) + draw(h, rand=True) * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = step + torch.log(-torch.expm1(-step))
    dt = torch.logaddexp(draw(b, s, h) + dt_bias, torch.zeros((), device=device))
    d = 1.0 + 0.3 * draw(h)
    if strided:
        whole = draw(b, s, h * hp + 2 * n + 8)
        xh = whole[..., :h * hp].reshape(b, s, h, hp)
        b_, c_ = whole[..., h * hp:h * hp + n], whole[..., h * hp + n:h * hp + 2 * n]
    else:
        xh, b_, c_ = draw(b, s, h, hp), draw(b, s, n), draw(b, s, n)
    return xh, dt, a, d, b_, c_, draw(b, s, h, hp)


def _run(fn, inputs, dtype=None):
    """fn's output and the gradients of its six inputs against dy, each
    input taken in `dtype` (as given where None)."""
    *ins, dy = inputs
    ins = [(t if dtype is None else t.to(dtype)).detach().requires_grad_() for t in ins]
    y = fn(*ins)
    grads = torch.autograd.grad(y, ins, dy.to(y.dtype))
    return tuple(t.detach() for t in (y, *grads))


# ---------------------------------------------------------------------------
# CPU: the plain version against autograd through `_ssd`

#: (S, H, P, N, chunk, tile): hymba's widths at its chunk, two chunks a
#: row; mamba2's state; the reduced configs'; the split scan's slices of 3
#: heads and 1; a tile that does not divide the chunk; the kernels' tile
#: at N = 128 (32); chunks of 100 and 1, which fill no whole tile
CPU_CASES = {
    "hymba-p64-n16-q256": (512, 2, 64, 16, 256, 64),
    "mamba2-n128-q128": (256, 2, 64, 128, 128, 32),
    "reduced-p16-n16-q16": (64, 4, 16, 16, 16, 64),
    "heads-3": (512, 3, 16, 16, 256, 64),
    "heads-1": (256, 1, 64, 16, 128, 64),
    "tile-48-q80": (160, 2, 16, 16, 80, 48),
    "tile-16": (96, 2, 16, 16, 32, 16),
    "hymba-widths-q100": (300, 2, 64, 16, 100, 64),
    "chunk-1": (5, 2, 16, 16, 1, 64),
}


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_plain_version_matches_autograd_through_ssd(case):
    """In f64 the two agree to 1e-11 of each result's largest value (the
    f64 sums of two orders), except that `_ssd` takes the D term through
    ``xh.float()``, whose backward rounds D * dy to f32: dxh within one f32
    rounding of it more."""
    s, h, hp, n, q, tile = CPU_CASES[case]
    inputs = [t.double() for t in _inputs(len(case), s=s, h=h, hp=hp, n=n)]
    got = _run(lambda *t: ssd_scan_ref(*t, q, tile), inputs)
    want = _run(lambda *t: ssm._ssd(*t, q), inputs)
    d, dy = inputs[3], inputs[-1]
    for name, a, b in zip(NAMES, got, want):
        atol = 1e-11 * float(b.abs().max())
        if name == "dxh":
            atol += 2**-24 * float(d.abs().max() * dy.abs().max())
        torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=lambda m, n=name: f"{n}: {m}")


def test_plain_version_equals_the_recurrence_token_by_token():
    """The plain version against h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t,
    y_t = C_t h_t + D x_t in f64 (atol 1e-10, rtol 1e-8, as `_ssd`'s)."""
    xh, dt, a, d, b_, c_, _ = (t.double() for t in _inputs(3, h=3, hp=8))
    y = ssd_scan_ref(xh, dt, a, d, b_, c_, 64, 32)
    state = torch.zeros(1, a.shape[0], xh.shape[-1], b_.shape[-1], dtype=torch.float64)
    want = []
    for t in range(xh.shape[1]):
        state = (state * torch.exp(dt[:, t] * a)[..., None, None]
                 + dt[:, t, :, None, None] * xh[:, t, :, :, None] * b_[:, t, None, None, :])
        want.append(torch.einsum("bhpn,bn->bhp", state, c_[:, t]) + d[:, None] * xh[:, t])
    torch.testing.assert_close(y, torch.stack(want, dim=1), atol=1e-10, rtol=1e-8)


def test_cpu_call_builds_and_launches_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU call reached the CUDA build")

    monkeypatch.setattr(_lib, "nvcc_path", refuse)
    monkeypatch.setattr(_lib, "build", refuse)
    monkeypatch.setattr(_lib, "load_library", refuse)
    monkeypatch.setattr(_lib.subprocess, "run", refuse)
    monkeypatch.setattr(kernel_module, "launches", dict.fromkeys(kernel_module.launches, 0))
    inputs = _inputs(0, s=256, h=2, hp=16)
    _run(lambda *t: ssm._ssd(*t, 64), inputs)
    with torch.no_grad():
        ssm._ssd(*inputs[:-1], 64)
    assert set(kernel_module.launches.values()) == {0}


def test_kernel_refuses_cpu_tensors():
    xh, dt, a, d, b_, c_, _ = _inputs(0, s=256, h=2, hp=64)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssd_scan(xh, dt, a, d, b_, c_, 64)


@pytest.mark.parametrize("hp,n,q,s,match", [
    (32, 16, 64, 256, "head_dim, state"),    # P with no instance
    (64, 64, 64, 256, "head_dim, state"),    # N with no instance
    (16, 128, 64, 256, "head_dim, state"),   # a pair of widths with no instance
    (64, 16, 256, 128, "chunk 256"),         # a chunk longer than the row
    (64, 16, 512, 512, "chunk 512"),         # past the longest chunk
    (64, 16, 64, 320 - 16, "chunk 64"),      # a chunk that does not divide the row
])
def test_kernel_refuses_unsupported_shapes(hp, n, q, s, match):
    xh, dt, a, d, b_, c_, _ = _inputs(0, s=s, h=2, hp=hp, n=n)
    with pytest.raises(ValueError, match=re.escape(match)):
        kernel_module._check_shape(xh, dt, a, d, b_, c_, q)


@pytest.mark.parametrize("q,s", [(1, 7), (24, 240), (100, 100), (100, 300), (256, 256)])
def test_kernel_takes_any_chunk_that_divides_the_row(q, s):
    """A prefill shorter than the config's chunk takes Q = S, so the
    kernels take any chunk up to 256 that divides the row."""
    xh, dt, a, d, b_, c_, _ = _inputs(0, s=s, h=2, hp=64, n=16)
    kernel_module._check_shape(xh, dt, a, d, b_, c_, q)


def test_kernel_takes_every_instance_at_its_strides():
    for hp, n in INSTANCES:
        xh, dt, a, d, b_, c_, _ = _inputs(0, s=256, h=2, hp=hp, n=n, strided=True)
        assert not xh.is_contiguous() and not b_.is_contiguous()
        kernel_module._check_shape(xh, dt, a, d, b_, c_, 256)


def test_each_instance_builds_its_own_library_without_ftz(tmp_path, monkeypatch):
    monkeypatch.setattr(_lib, "build_dir", lambda: tmp_path)
    src = _lib.kernel_source("ssd_scan.cu", kernel_module.CSRC)
    paths = {pn: _lib._library_path(src, library_flags(*pn)) for pn in INSTANCES}
    assert len(set(paths.values())) == len(INSTANCES)
    for (hp, n) in INSTANCES:
        flags = library_flags(hp, n)
        assert f"-DSSD_P={hp}" in flags and f"-DSSD_N={n}" in flags
        assert "arch=compute_90a,code=sm_90a" in flags
        assert not any("ftz" in f or "fast-math" in f or "fast_math" in f for f in flags)


def test_bind_declares_every_pointer_as_a_pointer():
    names = ("ssd_chunk", "ssd_state_pass", "ssd_output", "ssd_backward", "ssd_reduce",
             "ssd_error_string")
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in names})
    kernel_module._bind(lib)
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    shape = [i] * 4 + [q] * 7
    assert lib.ssd_chunk.argtypes == [p] * 10 + shape + [p]
    assert lib.ssd_state_pass.argtypes == [p] * 3 + [i] * 4 + [p]
    assert lib.ssd_output.argtypes == [p] * 8 + shape + [p]
    assert lib.ssd_backward.argtypes == [p] * 18 + shape + [p]
    assert lib.ssd_reduce.argtypes == [p] * 8 + [i] * 5 + [p]


def test_the_source_sums_with_no_atomics_and_rounds_no_operand():
    """Deterministic (no atomic adds), and f32 precision: no TF32, no half,
    no fast-math intrinsics; the tensor-core products take every operand as
    three bf16 parts and sum the part products with i + j <= 2, the
    attention kernel's split."""
    text = _lib.kernel_source("ssd_scan.cu", kernel_module.CSRC).read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert not re.search(r"\batomic[A-Z]|\batom\.|\bred\.", code)
    for name in ("tf32", "__half", "__expf", "__fdividef", "__float2bfloat16"):
        assert name not in code, name
    assert "constexpr int NPART = 3;" in code
    # every MMA sits in one of the three products' i + j <= 2 blocks (two
    # each), besides its definition
    assert len(re.findall(r"if \(i \+ j <= 2\) \{", code)) == 3
    assert len(re.findall(r"\bmma\(", code)) == 3 * 2 + 1


def test_the_smoke_names_each_ptxas_entry_and_exempts_two_spills():
    """`chip_smoke.py`'s build phase reads each kernel's name from ptxas's
    mangled entry line, and lets pass the spills of two named kernels of
    instances the scan builds: mamba2's backward and the reduced configs'
    chunk kernel."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    line = ("ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__7b471032_11_ssd_scan_cu_"
            "ssd_tile19ssd_backward_kernelENS_7BwdArgsE' for 'sm_90a'")
    assert smoke.entry_kernel(line) == "ssd_backward_kernel"
    assert smoke.entry_kernel("Compiling entry function 'tick_kernel' for 'sm_90a'") == "tick_kernel"
    assert set(smoke.SPILL_EXEMPT) == {("ssd_scan (64, 128)", "ssd_backward_kernel"),
                                       ("ssd_scan (16, 16)", "ssd_chunk_kernel")}
    assert {(64, 128), (16, 16)} <= set(INSTANCES)


# ---------------------------------------------------------------------------
# the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: (B, S, H, P, N, chunk, strided): hymba-1.5b's layer in its train cell
#: (the conv's output sliced, as `apply_ssm` passes it); mamba2-130m's
#: widths (N 128) at its chunk; the reduced configs' (16, 16, chunk 16);
#: the split scan's slices of 3 heads and 1; chunks of 80 and 32; chunks
#: that fill no whole tile: a 100-token prefill at hymba's widths (Q = S),
#: three chunks of 100, mamba2's widths at 40, and chunks of one position
CARD_CASES = {
    "hymba-layer": (4, 4096, 50, 64, 16, 256, True),
    "hymba-small": (2, 1024, 5, 64, 16, 256, False),
    "mamba2": (2, 1024, 24, 64, 128, 256, True),
    "mamba2-heads-1-q128": (1, 512, 1, 64, 128, 128, False),
    "reduced": (2, 128, 4, 16, 16, 16, True),
    "reduced-heads-3-q80": (1, 320, 3, 16, 16, 80, False),
    "hymba-heads-1-q32": (3, 96, 1, 64, 16, 32, False),
    "hymba-prefill-100": (2, 100, 50, 64, 16, 100, True),
    "reduced-q100-three-chunks": (1, 300, 3, 16, 16, 100, False),
    "mamba2-q40": (1, 120, 4, 64, 128, 40, True),
    "reduced-q1": (1, 5, 2, 16, 16, 1, False),
}

#: beyond 4x the plain f32 version's own error against f64, this share of
#: each result's largest value: a few f32 roundings of its largest term,
#: which two orders of f32 sums may part by where the plain version's sum
#: happens to fall near its f64 value
CARD_ATOL = 2**-20


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_ssd_against_f64(card, case):
    """The kernels' output and the gradients of all six inputs in f32,
    against the plain `_ssd` in f64 on the card: at most 4x the plain
    version's own f32 error against f64, plus `CARD_ATOL` of the largest
    value."""
    b, s, h, hp, n, q, strided = CARD_CASES[case]
    inputs = _inputs(len(case), b=b, s=s, h=h, hp=hp, n=n, device=card, strided=strided)
    got = _run(lambda *t: ssm._ssd(*t, q), inputs)
    plain = _run(lambda *t: ssm._ssd_plain(*t, q), inputs)
    exact = _run(lambda *t: ssm._ssd_plain(*t, q), inputs, torch.float64)
    for name, k, p, e in zip(NAMES, got, plain, exact):
        assert k.dtype == torch.float32 and torch.isfinite(k).all(), name
        err_k = float((k.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        limit = 4 * err_p + CARD_ATOL * float(e.abs().max())
        assert err_k <= limit, f"{case} {name}: kernel {err_k:.3e}, plain {err_p:.3e}"
        del k, p, e


@pytest.mark.card
def test_kernel_is_deterministic(card):
    inputs = _inputs(7, b=2, s=2048, h=50, hp=64, n=16, device=card, strided=True)
    first = _run(lambda *t: ssm._ssd(*t, 256), inputs)
    second = _run(lambda *t: ssm._ssd(*t, 256), inputs)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take(card):
    xh, dt, a, d, b_, c_, _ = _inputs(0, s=256, h=2, hp=32, device=card)
    with pytest.raises(ValueError, match="head_dim, state"):
        ssm._ssd(xh, dt, a, d, b_, c_, 64)
    xh, dt, a, d, b_, c_, _ = _inputs(0, s=240, h=2, hp=64, device=card)
    with pytest.raises(ValueError, match="chunk 64"):
        ssm._ssd(xh, dt, a, d, b_, c_, 64)
    with pytest.raises(ValueError, match="dtype"):
        ssm._ssd(xh.double(), dt, a, d, b_, c_, 48)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssd_scan(xh, dt, a.cpu(), d, b_, c_, 48)


@pytest.mark.card
def test_hymba_ssd_takes_the_kernel(card, monkeypatch):
    """Two layers of hymba-1.5b at full width over 2 x 2,048 tokens in the
    train step, remat on: each layer's scan runs its three forward
    launches twice (the pass and the layer's recompute) and its four
    backward launches once; a no-grad forward launches the forward's three
    once a layer; the loss and every updated weight are finite."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import BASELINE_PLAN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=2)
    assert cfg.remat and cfg.ssm_chunk == 256
    assert (cfg.ssm_head_dim, cfg.ssm_state) == (64, 16)
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
    forward = ("forward_chunk", "forward_state", "forward_output")
    assert kernel_module.launches == {**dict.fromkeys(forward, 4),
                                      **dict.fromkeys(("backward_chunk", "backward_state",
                                                       "backward_main", "backward_reduce"), 2)}
    with torch.no_grad():
        model.forward(state.params, batch)
    assert all(kernel_module.launches[k] == 6 for k in forward)
