"""The card's SSD mixer chains (`repro_torch.kernels.ssd.mixer`: the conv
with its silu and dt's softplus, the gated RMS norm) and the plain
version of their arithmetic.

On the CPU: each plain version (`conv_silu_dt_ref`, `gated_rms_norm_ref`:
the kernels' arithmetic and hand-written backwards) against autograd
through the model's plain code (`ssm._causal_conv` + silu + `_softplus`,
and `ssm._gated_norm`) in f64, the outputs and every gradient, at
hymba-1.5b's widths at a short length, mamba2-130m's, batch 2, conv widths
1 to 4 and channel counts no multiple of 8; a row's conv reads no other
row; the two backwards' shared gradient of ``in_proj``'s output, and the
mixer's card route wired on the CPU through stand-ins for the launches,
against the plain `apply_ssm`; a CPU call builds and launches nothing;
the refusals; the routing; the source sums with no atomics; the ctypes
bind.  Marked ``card`` (skipped without a CUDA device): each kernel's
output and gradients against its plain version, held to f64, at hymba's
layer and at other widths; two runs bit for bit; the launches of a hymba
train step; the paths that keep the plain code.  Run them on a card with
``python -m pytest -q -m card tests/test_torch_ssd_mixer.py``.
"""
import ctypes
import dataclasses
import re
import types

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import _lib
from repro_torch.kernels.ssd import ProjGrad, conv_silu_dt, conv_silu_dt_ref
from repro_torch.kernels.ssd import gated_rms_norm, gated_rms_norm_ref
from repro_torch.kernels.ssd import mixer
from repro_torch.models import ssm

CONV_NAMES = ("x", "b", "c", "dt", "dzx", "dconv_w", "dconv_b", "ddt_bias")
NORM_NAMES = ("out", "dy", "dzx", "dscale")


def _inputs(seed, b, s, d, n, h, w, dtype=torch.float64, device="cpu"):
    """zx [B, S, 2D + 2N + H], conv_w, conv_b, dt_bias, y [B, S, D], the
    norm's scale, and the gradients of the conv's four outputs and of the
    norm's (Mamba-2's scales: dt_bias the inverse softplus of a step in
    [1e-3, 1e-1])."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(shape, generator=g, device=device)

    step = torch.exp(-6.9 + 4.6 * torch.rand((h,), generator=g, device=device))
    return dict(
        zx=draw(b, s, 2 * d + 2 * n + h).to(dtype),
        conv_w=draw(w, d + 2 * n, scale=0.5).to(dtype),
        conv_b=draw(d + 2 * n, scale=0.1).to(dtype),
        dt_bias=(step + torch.log(-torch.expm1(-step))).to(
            torch.float64 if dtype == torch.float64 else torch.float32),
        y=draw(b, s, d).to(torch.float64 if dtype == torch.float64 else torch.float32),
        scale=draw(d, scale=0.2, shift=1.0).to(dtype),
        g_conv=[draw(b, s, k).to(torch.float64 if dtype == torch.float64 else torch.float32)
                for k in (d, n, n, h)],
        g_norm=draw(b, s, d).to(dtype))


def _plain_conv(zx, conv_w, conv_b, dt_bias, d, n):
    """The model's plain chain: `_causal_conv`, silu, `_softplus`."""
    c = d + 2 * n
    out = F.silu(ssm._causal_conv(zx[..., d:d + c], conv_w, conv_b))
    return (*torch.split(out, [d, n, n], dim=-1), ssm._softplus(zx[..., d + c:] + dt_bias))


def _plain_norm(y, zx, scale):
    return ssm._gated_norm(types.SimpleNamespace(gate_norm_scale=scale), y,
                           zx[..., :y.shape[-1]])


def _conv_run(fn, t):
    """fn's four outputs and the gradients of zx, conv_w, conv_b, dt_bias."""
    ins = [t[k].detach().requires_grad_() for k in ("zx", "conv_w", "conv_b", "dt_bias")]
    outs = fn(*ins)
    grads = torch.autograd.grad(outs, ins, [g.to(o.dtype) for g, o in zip(t["g_conv"], outs)])
    return [x.detach() for x in (*outs, *grads)]


def _norm_run(fn, t):
    ins = [t[k].detach().requires_grad_() for k in ("y", "zx", "scale")]
    out = fn(*ins)
    grads = torch.autograd.grad(out, ins, t["g_norm"].to(out.dtype))
    return [x.detach() for x in (out, *grads)]


# ---------------------------------------------------------------------------
# CPU: the plain versions against autograd through the model's plain code

#: (B, S, d_inner, N, H, conv width): hymba-1.5b's widths at a short
#: length; mamba2-130m's; batch 2 at the reduced configs' widths; conv
#: widths 3, 2 and 1; channel counts no multiple of 8 (odd ones)
CPU_CASES = {
    "hymba-widths": (1, 24, 3200, 16, 50, 4),
    "mamba2-widths": (1, 16, 1536, 128, 24, 4),
    "batch-2": (2, 40, 128, 16, 8, 4),
    "width-3": (2, 19, 64, 16, 4, 3),
    "width-2": (1, 21, 48, 8, 6, 2),
    "width-1": (1, 9, 32, 8, 2, 1),
    "channels-37-odd": (2, 23, 37, 3, 5, 4),
    "channels-44": (1, 30, 44, 6, 7, 3),
}


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_conv_plain_version_matches_autograd(case):
    """In f64 the conv's four outputs and the gradients of zx (z's columns
    zero), conv_w, conv_b and dt_bias agree with autograd through the
    model's chain to 1e-12 of each one's largest value."""
    b, s, d, n, h, w = CPU_CASES[case]
    t = _inputs(len(case), b, s, d, n, h, w)
    got = _conv_run(lambda *a: conv_silu_dt_ref(*a, d, n), t)
    want = _conv_run(lambda *a: _plain_conv(*a, d, n), t)
    for name, x, y in zip(CONV_NAMES, got, want):
        assert x.dtype == torch.float64, name
        torch.testing.assert_close(x, y, atol=1e-12 * float(y.abs().max()), rtol=0,
                                   msg=lambda m, k=name: f"{k}: {m}")


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_norm_plain_version_matches_autograd(case):
    """In f64 the norm and the gradients of y, zx (z's columns, the rest
    zero) and the scale agree with autograd through `_gated_norm` to 1e-12
    of each one's largest value."""
    b, s, d, n, h, w = CPU_CASES[case]
    t = _inputs(len(case) + 1, b, s, d, n, h, w)
    got = _norm_run(gated_rms_norm_ref, t)
    want = _norm_run(_plain_norm, t)
    for name, x, y in zip(NORM_NAMES, got, want):
        assert x.dtype == torch.float64, name
        torch.testing.assert_close(x, y, atol=1e-12 * float(y.abs().max()), rtol=0,
                                   msg=lambda m, k=name: f"{k}: {m}")


def test_conv_reads_no_other_row():
    """Each row of a batch of two, alone, gives its own rows of the
    outputs and of zx's gradient: the causal pad starts every row from
    zeros, and the backward reads no tokens of the next row."""
    b, s, d, n, h, w = 2, 40, 64, 16, 8, 4
    t = _inputs(5, b, s, d, n, h, w)
    both = _conv_run(lambda *a: conv_silu_dt_ref(*a, d, n), t)
    for r in range(b):
        row = dict(t, zx=t["zx"][r:r + 1], g_conv=[g[r:r + 1] for g in t["g_conv"]])
        alone = _conv_run(lambda *a: conv_silu_dt_ref(*a, d, n), row)
        for name, x, y in zip(CONV_NAMES[:5], both, alone):
            torch.testing.assert_close(x[r:r + 1], y, atol=1e-13, rtol=0,
                                       msg=lambda m, k=name: f"row {r} {k}: {m}")


# ---------------------------------------------------------------------------
# CPU: the autograd plumbing, with plain stand-ins for the launches


@pytest.fixture
def plain_launches(monkeypatch):
    """The four launch functions replaced by the plain versions'
    arithmetic on any device (the dzx each backward is handed filled in
    its own columns), and the device checks skipped: the kernels' autograd
    Functions and `_apply_ssm_kernels` then run on the CPU.  Records each
    dzx the backwards are handed."""
    handed = []

    def conv_forward(zx, conv_w, conv_b, dt_bias, d, n):
        with torch.no_grad():
            return conv_silu_dt_ref(zx, conv_w, conv_b, dt_bias, d, n)

    def conv_backward(zx, conv_w, conv_b, dt_bias, d, n, gx, gb, gc, gdt, dzx):
        handed.append(("conv", dzx))
        ins = [x.detach().requires_grad_() for x in (zx, conv_w, conv_b, dt_bias)]
        with torch.enable_grad():
            dz, *grads = torch.autograd.grad(conv_silu_dt_ref(*ins, d, n), ins,
                                             (gx, gb, gc, gdt))
        dzx[..., d:] = dz[..., d:]
        return grads

    def norm_forward(y, zx, scale):
        with torch.no_grad():
            return gated_rms_norm_ref(y, zx, scale), None

    def norm_backward(y, zx, scale, rstd, g, dzx):
        handed.append(("norm", dzx))
        ins = [x.detach().requires_grad_() for x in (y, zx, scale)]
        with torch.enable_grad():
            dy, dz, dscale = torch.autograd.grad(gated_rms_norm_ref(*ins), ins, g)
        d = y.shape[-1]
        dzx[..., :d] = dz[..., :d]
        return dy, dscale

    monkeypatch.setattr(mixer, "_conv_forward", conv_forward)
    monkeypatch.setattr(mixer, "_conv_backward", conv_backward)
    monkeypatch.setattr(mixer, "_norm_forward", norm_forward)
    monkeypatch.setattr(mixer, "_norm_backward", norm_backward)
    monkeypatch.setattr(mixer, "_check_device", lambda *a: None)
    return handed


def test_the_two_backwards_fill_one_gradient_of_the_projection(plain_launches):
    """With a shared `ProjGrad`, the norm's backward hands its dzx to the
    conv's, which fills the other columns and returns that very tensor:
    zx's gradient is the plain versions' summed, made once."""
    b, s, d, n, h, w = 2, 24, 64, 16, 8, 4
    t = _inputs(2, b, s, d, n, h, w, dtype=torch.float32)
    zx = t["zx"].detach().requires_grad_()
    link = ProjGrad()
    x, b_, c_, dt = conv_silu_dt(zx, t["conv_w"], t["conv_b"], t["dt_bias"], d, n, link)
    y = t["y"] + x.sum() * 1e-3 + dt.mean() + b_.mean() - c_.mean()
    out = gated_rms_norm(y, zx, t["scale"], link)
    loss = (out * t["g_norm"]).sum()
    (got,) = torch.autograd.grad(loss, zx)
    assert [k for k, _ in plain_launches] == ["norm", "conv"]
    assert plain_launches[0][1] is plain_launches[1][1]
    assert link.grad is None

    zr = t["zx"].detach().requires_grad_()
    xr, br, cr, dtr = conv_silu_dt_ref(zr, t["conv_w"], t["conv_b"], t["dt_bias"], d, n)
    yr = t["y"] + xr.sum() * 1e-3 + dtr.mean() + br.mean() - cr.mean()
    (want,) = torch.autograd.grad((gated_rms_norm_ref(yr, zr, t["scale"]) * t["g_norm"]).sum(),
                                  zr)
    torch.testing.assert_close(got, want, atol=1e-13, rtol=0)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_card_route_matches_plain_apply_ssm(plain_launches, arch):
    """`_apply_ssm_kernels` with the plain versions standing in for the
    launches, against the plain `apply_ssm` on the same f32 weights: the
    output and every parameter's gradient within 1e-5 (the conv's sums
    and the norm's run in another order)."""
    cfg = get_config(arch).reduced()
    p = ssm.SSM(cfg, torch.float32, "cpu", torch.Generator().manual_seed(1))
    with torch.no_grad():
        for t in (p.A_log, p.D, p.dt_bias, p.conv_b, p.gate_norm_scale):
            t.add_(0.3 * torch.randn(t.shape, generator=torch.Generator().manual_seed(2)))
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(3))
    results = []
    for fn in (lambda: ssm._apply_ssm_kernels(p, x, cfg, cfg.ssm_chunk),
               lambda: ssm.apply_ssm(p, x, cfg)):
        p.zero_grad()
        y = fn()
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        results.append([y.detach()] + [q.grad.clone() for q in p.parameters()])
    assert [k for k, _ in plain_launches] == ["norm", "conv"]
    names = ["y"] + [name for name, _ in p.named_parameters()]
    for name, a, b in zip(names, *results):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5,
                                   msg=lambda m, k=name: f"{arch} {k}: {m}")


# ---------------------------------------------------------------------------
# CPU: routing, refusals, source and bind


def test_cpu_call_builds_and_launches_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU call reached the CUDA build")

    monkeypatch.setattr(_lib, "nvcc_path", refuse)
    monkeypatch.setattr(_lib, "build", refuse)
    monkeypatch.setattr(_lib, "load_library", refuse)
    monkeypatch.setattr(_lib.subprocess, "run", refuse)
    monkeypatch.setattr(mixer, "launches", dict.fromkeys(mixer.launches, 0))
    cfg = get_config("hymba-1.5b").reduced()
    p = ssm.SSM(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, cfg.d_model), requires_grad=True)
    ssm.apply_ssm(p, x, cfg).sum().backward()
    with torch.no_grad():
        ssm.apply_ssm(p, x, cfg)
    assert set(mixer.launches.values()) == {0}


def test_routing_takes_the_kernels_only_on_the_card_without_tp():
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert ssm._on_card(card, None)
    assert not ssm._on_card(card, types.SimpleNamespace(size=1))
    assert not ssm._on_card(torch.zeros(1), None)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = torch.empty(2, 8, 4, device="cuda")
        assert fake.device.type == "cuda" and not ssm._on_card(fake, None)


def test_wrappers_refuse_cpu_tensors():
    t = _inputs(0, 1, 8, 32, 8, 2, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        conv_silu_dt(t["zx"], t["conv_w"], t["conv_b"], t["dt_bias"], 32, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        gated_rms_norm(t["y"], t["zx"], t["scale"])


@pytest.mark.parametrize("width,d,n,h,match", [
    (5, 32, 8, 2, "width 5"),        # a conv wider than 4
    (8, 32, 8, 2, "width 8"),
    (4, 32, 8, 0, "hold no"),        # no dt columns
])
def test_conv_refuses_shapes_it_does_not_take(width, d, n, h, match):
    t = _inputs(0, 1, 8, d, n, max(h, 1), width, dtype=torch.bfloat16)
    zx = t["zx"][..., :2 * d + 2 * n + h]
    with pytest.raises(ValueError, match=re.escape(match)):
        mixer._check_conv_shape(zx, t["conv_w"], t["conv_b"], t["dt_bias"][:max(h, 1)], d, n)


def test_norm_refuses_shapes_it_does_not_take():
    t = _inputs(0, 2, 8, 32, 8, 2, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not fit"):
        mixer._check_norm_shape(t["y"], t["zx"], t["scale"][:16])
    with pytest.raises(ValueError, match="do not fit"):
        mixer._check_norm_shape(t["y"], t["zx"][:1], t["scale"])
    mixer._check_norm_shape(t["y"], t["zx"], t["scale"])
    mixer._check_conv_shape(t["zx"], t["conv_w"], t["conv_b"], t["dt_bias"], 32, 8)


def test_pairs_where_every_width_and_stride_is_even():
    """hymba's and mamba2's layouts load channel pairs; an odd width, an
    odd stride or an odd offset one channel at a time."""
    for d, n, h in ((3200, 16, 50), (1536, 128, 24)):
        zx = torch.empty((2, 4, 2 * d + 2 * n + h), dtype=torch.bfloat16)
        assert mixer._pairs(zx, widths=(d, n, zx.shape[-1])) == 2
    zx = torch.empty((2, 4, 2 * 37 + 6 + 5), dtype=torch.bfloat16)
    assert mixer._pairs(zx, widths=(37, 3, zx.shape[-1])) == 1
    zx = torch.empty((2, 4, 100), dtype=torch.bfloat16)[..., 1:91]
    assert mixer._pairs(zx, widths=(40, 4, 90)) == 1


def test_the_source_sums_with_no_atomics():
    text = _lib.kernel_source("ssd_mixer.cu", mixer.CSRC).read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "atomicAdd" not in code
    assert not re.search(r"\batomic[A-Z]|\batom\.|\bred\.", code)
    for name in ("__expf", "__fdividef", "__frsqrt_rn", "rsqrtf", "__half"):
        assert name not in code, name
    assert not any("ftz" in f or "fast" in f for f in mixer.library_flags())


def test_bind_declares_every_pointer_as_a_pointer():
    names = ("mixer_conv_forward", "mixer_conv_backward", "mixer_conv_reduce",
             "mixer_norm_forward", "mixer_norm_backward", "mixer_norm_reduce",
             "mixer_conv_blocks", "mixer_norm_blocks", "mixer_error_string")
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in names})
    mixer._bind(lib)
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert lib.mixer_conv_forward.argtypes == [p, q, q] + [p] * 7 + [i] * 8 + [p]
    assert lib.mixer_conv_backward.argtypes == [p, q, q] + [p] * 9 + [i] * 8 + [p]
    assert lib.mixer_conv_reduce.argtypes == [p] * 4 + [i] * 5 + [p]
    assert lib.mixer_norm_forward.argtypes == [p, p, q, q] + [p] * 3 + [i] * 5 + [p]
    assert lib.mixer_norm_backward.argtypes == [p, p, q, q] + [p] * 5 + [q, p] + [i] * 5 + [p]
    assert lib.mixer_norm_reduce.argtypes == [p, p] + [i] * 3 + [p]
    # each C signature's pointers, in the source, against the bind
    text = _lib.kernel_source("ssd_mixer.cu", mixer.CSRC).read_text()
    for name in names[:6]:
        sig = re.search(rf"int {name}\((.*?)\)\s*{{", text, re.S).group(1)
        kinds = [p if "*" in a else q if "long long" in a else i for a in sig.split(",")]
        assert getattr(lib, name).argtypes == kinds, name


# ---------------------------------------------------------------------------
# the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: (B, S, d_inner, N, H, width, dtype): hymba-1.5b's layer in its train
#: cell; mamba2-130m's widths; the reduced configs' in f32; widths 3, 2, 1;
#: odd channel counts (one channel a thread) in bf16 and f32
CARD_CASES = {
    "hymba-layer": (4, 4096, 3200, 16, 50, 4, torch.bfloat16),
    "mamba2": (2, 1024, 1536, 128, 24, 4, torch.bfloat16),
    "reduced-f32": (2, 128, 128, 16, 8, 4, torch.float32),
    "width-3": (2, 300, 256, 16, 8, 3, torch.bfloat16),
    "width-2": (1, 130, 64, 8, 4, 2, torch.bfloat16),
    "width-1": (1, 50, 64, 8, 4, 1, torch.float32),
    "odd-bf16": (2, 77, 37, 3, 5, 4, torch.bfloat16),
    "odd-f32": (3, 45, 45, 5, 3, 3, torch.float32),
}

#: beyond 4x the plain version's own error against f64 in the kernel's
#: precision, this share of each result's largest value: a few f32
#: roundings where the two sum in another order
CARD_ATOL = 2**-20


def _held_to_f64(case, got, plain, exact, names):
    for name, k, p, e in zip(names, got, plain, exact):
        assert k.dtype == p.dtype and torch.isfinite(k).all(), f"{case} {name}"
        err_k = float((k.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        limit = 4 * err_p + CARD_ATOL * float(e.abs().max())
        assert err_k <= limit, f"{case} {name}: kernel {err_k:.3e}, plain {err_p:.3e}"


def _f64(t):
    return {k: ([x.double() for x in v] if isinstance(v, list) else v.double())
            for k, v in t.items()}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernels_match_their_plain_versions_against_f64(card, case):
    """Each kernel's output and gradients, against its plain version in the
    same dtypes and in f64 on the card: at most 4x the plain version's
    error against f64, plus `CARD_ATOL` of the largest value."""
    b, s, d, n, h, w, dtype = CARD_CASES[case]
    t = _inputs(len(case), b, s, d, n, h, w, dtype=dtype, device=card)
    exact_t = _f64(t)
    got = _conv_run(lambda *a: conv_silu_dt(*a, d, n), t)
    plain = _conv_run(lambda *a: conv_silu_dt_ref(*a, d, n), t)
    exact = _conv_run(lambda *a: conv_silu_dt_ref(*a, d, n), exact_t)
    _held_to_f64(case, got, plain, exact, CONV_NAMES)
    del got, plain, exact
    got = _norm_run(gated_rms_norm, t)
    plain = _norm_run(gated_rms_norm_ref, t)
    exact = _norm_run(gated_rms_norm_ref, exact_t)
    _held_to_f64(case, got, plain, exact, NORM_NAMES)


@pytest.mark.card
def test_kernels_are_deterministic(card):
    b, s, d, n, h, w = 4, 2048, 3200, 16, 50, 4
    t = _inputs(7, b, s, d, n, h, w, dtype=torch.bfloat16, device=card)
    for run in (_conv_run, _norm_run):
        fn = (lambda *a: conv_silu_dt(*a, d, n)) if run is _conv_run else gated_rms_norm
        first, second = run(fn, t), run(fn, t)
        for a, b_ in zip(first, second):
            assert torch.equal(a, b_)


@pytest.mark.card
def test_kernels_refuse_what_they_do_not_take(card):
    t = _inputs(0, 1, 64, 32, 8, 2, 4, dtype=torch.bfloat16, device=card)
    wide = torch.zeros((5, 48), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="width 5"):
        conv_silu_dt(t["zx"], wide, t["conv_b"], t["dt_bias"], 32, 8)
    with pytest.raises(ValueError, match="dtype"):
        conv_silu_dt(t["zx"].half(), t["conv_w"].half(), t["conv_b"].half(), t["dt_bias"], 32, 8)
    with pytest.raises(ValueError, match="dtype"):
        gated_rms_norm(t["y"].bfloat16(), t["zx"], t["scale"])
    with pytest.raises(ValueError, match="not a CUDA device"):
        gated_rms_norm(t["y"], t["zx"], t["scale"].cpu())


@pytest.mark.card
def test_hymba_apply_ssm_takes_both_kernels(card, monkeypatch):
    """Two layers of hymba-1.5b at full width over 2 x 2,048 tokens in the
    train step, remat on: each layer runs each forward kernel twice (the
    pass and the layer's recompute) and each backward kernel and each
    reduction once; a no-grad forward runs each forward kernel once a
    layer; the loss and every updated weight are finite."""
    from repro_torch.distributed.sharding import BASELINE_PLAN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=2)
    assert cfg.remat and cfg.ssm_conv_width == 4
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), device="cuda")
    step, _ = build_train_step(model, make_local_mesh(device="cuda"), BASELINE_PLAN,
                               AdamWConfig())
    tokens = torch.randint(0, cfg.vocab_size, (2, 2049), device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    monkeypatch.setattr(mixer, "launches", dict.fromkeys(mixer.launches, 0))
    state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    for name, p in state.params.named_parameters():
        assert torch.isfinite(p).all(), name
    layers = cfg.n_layers
    assert mixer.launches == {"conv_forward": 2 * layers, "norm_forward": 2 * layers,
                              **dict.fromkeys(("conv_backward", "conv_reduce", "norm_backward",
                                               "norm_reduce"), layers)}
    with torch.no_grad():
        model.forward(state.params, batch)
    assert mixer.launches["conv_forward"] == mixer.launches["norm_forward"] == 3 * layers


@pytest.mark.card
def test_other_paths_keep_the_plain_code(card, monkeypatch):
    """`apply_ssm` with a tensor-parallel context (one rank: the plain
    code's every `tp` branch whole), `split_ssm`, `decode_ssm` and CPU
    tensors launch no mixer kernel; on the card without `tp` the kernels'
    mixer agrees with the plain one."""
    monkeypatch.setattr(mixer, "launches", dict.fromkeys(mixer.launches, 0))
    cfg = get_config("mamba2-130m").reduced()
    p = ssm.SSM(cfg, torch.float32, "cuda", torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, cfg.d_model), device="cuda")
    tp = types.SimpleNamespace(size=1, dim=lambda w: None)
    with torch.no_grad():
        plain = ssm.apply_ssm(p, x, cfg, tp)
        ssm.split_ssm(p, x, cfg, 2)
        ssm.decode_ssm(p, ssm.init_ssm_cache(cfg, 2, "cuda"), x[:, :1], cfg)
        p_cpu = ssm.SSM(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
        ssm.apply_ssm(p_cpu, x.cpu(), cfg)
        assert set(mixer.launches.values()) == {0}
        got = ssm.apply_ssm(p, x, cfg)
    assert mixer.launches["conv_forward"] == mixer.launches["norm_forward"] == 1
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
