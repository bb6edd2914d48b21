"""The PyTorch port's decode path and serve driver against the reference,
on CPU.

Decode attention and the KV-cache writes in both layouts, the decode
step of every decoder-only family teacher-forced (logits each step and
the caches at the end), the greedy serve loop and `launch/serve.run`.
Weights are the reference's, carried across with `params_from_jax`;
inputs are made with numpy from a seed.  All f32 on reduced configs
except where a dtype is named.  Tolerances (stated where used):
- decode attention: atol 1e-5, rtol 1e-5 in f32; in bf16 within one
  bf16 rounding of the reference's (atol 1e-2, rtol 2**-7);
- cache writes: exact;
- decode steps: logits and caches atol 1e-5, rtol 1e-5 (dense, moe,
  vlm) and atol 1e-5, rtol 1e-4 (ssm, hybrid: the SSD state);
- greedy tokens and the serve driver's sample: equal;
- the sequence-parallel softmax's plain version (`chunked_decode_attention`)
  against the one-chunk form: atol/rtol 1e-6 in f32 (the sums' order);
  in bf16 within one bf16 rounding (atol 1e-2, rtol 2**-7): with
  cast_f32=False the probabilities round to bf16 where the one-chunk
  form rounds them, after normalising, but a sum over the chunks can
  put one on the other side of a rounding boundary.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import BASELINE_PLAN, DECODE_PLAN  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.steps import build_prefill_step, build_serve_step  # noqa: E402
from repro_torch.models import attention, build_model, moe  # noqa: E402
from repro_torch.models.transformer import cache_len_for, params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Decode attention and the cache writes
# ---------------------------------------------------------------------------

#: layout -> (port attention, port write, reference attention, reference write)
LAYOUTS = {
    "bskd": (attention.decode_attention, attention.update_kv_cache,
             ref_attention.decode_attention, ref_attention.update_kv_cache),
    "bksd": (attention.decode_attention_bksd, attention.update_kv_cache_bksd,
             ref_attention.decode_attention_bksd, ref_attention.update_kv_cache_bksd),
}


def _cache(layout, rng, b=2, s=24, kv=2, d=16):
    shape = (b, s, kv, d) if layout == "bskd" else (b, kv, s, d)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cast_f32", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_attention(layout, cast_f32, dtype):
    """One token against a cache filled to 11 of 24 positions (the rest
    garbage, masked with the reference's NEG), four query heads on two KV
    heads.  f32: atol/rtol 1e-5; bf16: one bf16 rounding (atol 1e-2, rtol
    2**-7), the probabilities rounded to bf16 before PV when
    cast_f32=False, as the reference does."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k, v = _cache(layout, rng), _cache(layout, rng)
    port, _, ref, _ = LAYOUTS[layout]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = ref(*(jnp.asarray(a, jd) for a in (q, k, v)), jnp.int32(11), cast_f32=cast_f32)
    got = port(*(torch.from_numpy(a).to(td) for a in (q, k, v)), 11, cast_f32=cast_f32)
    assert got.dtype == td and got.shape == (2, 1, 4, 16)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=2**-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cast_f32", [True, False])
@pytest.mark.parametrize("chunks", [1, 2, 3, 6])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chunked_decode_attention_equals_the_one_chunk_form(layout, chunks, cast_f32, dtype):
    """The sequence-parallel decode's softmax in one process: the 24
    positions of `test_decode_attention`'s cache in `chunks` equal chunks
    (filled to 11, so with 3 and 6 chunks whole chunks are masked), the
    max, the sum of exponentials and the PV product combined over the
    chunks, against `decode_attention` on the whole cache."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k, v = _cache(layout, rng), _cache(layout, rng)
    port = LAYOUTS[layout][0]
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(td) for a in (q, k, v))
    seq = 1 if layout == "bskd" else 2
    got = attention.chunked_decode_attention(q, k.chunk(chunks, seq), v.chunk(chunks, seq), 11,
                                             cast_f32=cast_f32, layout=layout)
    want = port(q, k, v, 11, cast_f32=cast_f32)
    assert got.dtype == td and got.shape == want.shape
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=2**-7)


@pytest.mark.parametrize("index", [0, 7, 23])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_update_kv_cache(layout, index):
    """The write lands where the reference's does, cast to the cache
    dtype (bf16 here), every other position untouched: exact."""
    rng = np.random.default_rng(index)
    kc, vc = _cache(layout, rng), _cache(layout, rng)
    kn = rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
    vn = rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
    _, port, _, ref = LAYOUTS[layout]
    want = ref(jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16),
               jnp.asarray(kn), jnp.asarray(vn), jnp.int32(index))
    caches = (torch.from_numpy(kc).bfloat16(), torch.from_numpy(vc).bfloat16())
    got = port(*caches, torch.from_numpy(kn), torch.from_numpy(vn), index)
    for g, w, c in zip(got, want, caches):
        assert g is c  # written in place
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Decode steps, teacher-forced
# ---------------------------------------------------------------------------

#: case -> (arch, config overrides, decode steps); the reduced configs'
#: window is 32, so 80 steps decode 48 past the ring buffer's wrap
DECODE_CASES = {
    "dense-bskd": ("paper-gpt-125m", {}, 20),
    "dense-bksd": ("paper-gpt-125m", {"cache_layout": "bksd"}, 20),
    "gqa-sliding-bksd": ("granite-3-2b", {"attention": "sliding",
                                          "cache_layout": "bksd"}, 40),
    "hybrid-past-window": ("hymba-1.5b", {}, 80),
    "ssm": ("mamba2-130m", {}, 24),
    "moe-drops": ("phi3.5-moe-42b-a6.6b", {}, 20),
    "vlm": ("internvl2-1b", {}, 12),
}
DECODE_B = 4


def _decode_models(case):
    arch, extra, _ = DECODE_CASES[case]
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **extra)
    cfg = dataclasses.replace(get_config(arch).reduced(), **extra)
    params = ref_tfm.init_lm(jax.random.PRNGKey(3), rcfg)
    model = build_model(cfg)
    module = model.init(device="cpu")
    module.load_state_dict(params_from_jax(_np(params), cfg))
    return rcfg, cfg, params, model, module


def _drop_counter(module, cfg):
    """`moe.dropped` of each MoE call: (token, slot) assignments past an
    expert's capacity."""
    drops = []
    for layer in module.layers:
        layer.moe.register_forward_hook(
            lambda mod, inputs, _out: drops.append(int(moe.dropped(mod, inputs[0], cfg))))
    return drops


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_step_teacher_forced(case):
    """`decode_step` against the reference's `decode_step_lm` step by
    step on the same tokens: logits at every step, caches leaf for leaf
    at the end (atol 1e-5; rtol 1e-5, 1e-4 with an SSD state)."""
    rcfg, cfg, params, model, module = _decode_models(case)
    steps = DECODE_CASES[case][2]
    rtol = 1e-4 if cfg.family in ("ssm", "hybrid") else 1e-5
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (steps, DECODE_B, 1)).astype(np.int32)
    ref_caches = ref_tfm.init_decode_caches(rcfg, DECODE_B, steps)
    ref_step = jax.jit(lambda c, t, i: ref_tfm.decode_step_lm(params, rcfg, c, t, i, steps))
    caches = model.init_caches(module, DECODE_B, steps)
    assert {k: tuple(v.shape) for k, v in caches.items()} == {
        k: v.shape for k, v in ref_caches.items()}
    drops = _drop_counter(module, cfg) if cfg.family == "moe" else None
    for i, t in enumerate(tokens):
        want, ref_caches = ref_step(ref_caches, jnp.asarray(t), jnp.int32(i))
        got, out = model.decode_step(module, caches, torch.from_numpy(t), i, steps)
        assert out is caches
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=rtol, err_msg=f"step {i}")
    for name, c in caches.items():
        np.testing.assert_allclose(c.numpy(), np.asarray(ref_caches[name]),
                                   atol=1e-5, rtol=rtol, err_msg=name)
    if cfg.attention == "sliding":
        assert cache_len_for(cfg, steps) == cfg.window < steps  # wrapped
    if drops is not None:
        # cap = max(int(2 * 4 * 1.25 / 4), 2) = 2 slots an expert
        assert sum(drops) > 0, drops


# ---------------------------------------------------------------------------
# Greedy serving
# ---------------------------------------------------------------------------

GREEDY_ARCHS = ("paper-gpt-125m", "hymba-1.5b", "mamba2-130m", "phi3.5-moe-42b-a6.6b")


@pytest.mark.parametrize("arch", GREEDY_ARCHS)
def test_greedy_serve_loop_equals_the_reference(arch):
    """The port's serve step fed a prompt token by token, then 16 greedy
    tokens, against the reference's `model.decode_step` loop on the same
    prompts and weights: equal tokens."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    b, p, n = 3, 8, 16
    seq = p + n
    ref_model, model = ref_build_model(rcfg), build_model(cfg)
    params = ref_model.init(jax.random.PRNGKey(5))
    module = model.init(device="cpu")
    module.load_state_dict(params_from_jax(_np(params), cfg))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, p)).astype(np.int32)

    ref_step = jax.jit(lambda c, t, i: ref_model.decode_step(params, c, t, i, seq))
    ref_caches = ref_model.init_caches(params, b, seq)
    serve_step, _ = build_serve_step(model, make_local_mesh(device="cpu"), DECODE_PLAN, seq)
    caches = model.init_caches(module, b, seq)
    for i in range(p):
        ref_logits, ref_caches = ref_step(ref_caches, jnp.asarray(prompts[:, i:i + 1]),
                                          jnp.int32(i))
        logits, caches = serve_step(module, caches, torch.from_numpy(prompts[:, i:i + 1]), i)
    want, got = [], []
    ref_tok = jnp.argmax(ref_logits[:, -1:, :], axis=-1).astype(jnp.int32)
    tok = torch.argmax(logits[:, -1:, :], dim=-1)
    for j in range(n):
        ref_logits, ref_caches = ref_step(ref_caches, ref_tok, jnp.int32(p + j))
        logits, caches = serve_step(module, caches, tok, p + j)
        ref_tok = jnp.argmax(ref_logits[:, -1:, :], axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
        want.append(np.asarray(ref_tok)[:, 0])
        got.append(tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_prefill_step_is_the_forward_without_grad():
    cfg = get_config("paper-gpt-125m").reduced()
    model = build_model(cfg)
    module = model.init(device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=torch.Generator().manual_seed(0))}
    prefill, _ = build_prefill_step(model, make_local_mesh(device="cpu"), BASELINE_PLAN)
    logits = prefill(module, batch)
    assert not logits.requires_grad
    with torch.no_grad():
        torch.testing.assert_close(logits, model.forward(module, batch), rtol=0, atol=0)


def _serve_args(extra=()):
    return ["--arch", "paper-gpt-125m", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--decode", "8", *extra]


def test_serve_run_equals_the_reference_run():
    """`launch/serve.run` on the CPU, handed the reference run's weights
    (PRNGKey(0)) and prompts: the reference's JSON keys, `decoded`, and
    its sample of greedy tokens."""
    argv = _serve_args()
    want = ref_serve.run(ref_serve.make_argparser().parse_args(argv))
    rcfg = ref_config("paper-gpt-125m").reduced()
    rng = jax.random.PRNGKey(0)
    params = ref_build_model(rcfg).init(rng)
    prompts = np.array(jax.random.randint(rng, (2, 8), 0, rcfg.vocab_size))
    got = serve.run(serve.make_argparser().parse_args(argv + ["--device", "cpu"]),
                    params=params_from_jax(_np(params), get_config("paper-gpt-125m").reduced()),
                    prompts=prompts)
    assert set(got) == set(want)
    assert got["decoded"] == want["decoded"] == 8
    assert got["sample_output"] == want["sample_output"]
    assert got["arch"] == want["arch"] and got["batch"] == want["batch"]


def test_serve_run_labels_its_windows():
    """Past one window the driver labels it and routes to a serving
    stage; the same seed gives the same tokens twice."""
    argv = _serve_args(["--decode", "24", "--window", "8", "--device", "cpu"])
    out = serve.run(serve.make_argparser().parse_args(argv))
    again = serve.run(serve.make_argparser().parse_args(argv))
    assert out["decoded"] == 24 and out["tokens_per_second"] > 0
    assert "frontier_accounting" in out["last_window_labels"]
    assert out["last_window_routing"]
    assert set(out["last_window_routing"]) <= set(serve.SERVE_STAGES)
    assert out["sample_output"] == again["sample_output"]


def test_serve_module_prints_the_reference_keys():
    """`python -m repro_torch.launch.serve ... --device cpu` prints one
    JSON object with the reference's keys and `decoded == 8`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *_serve_args(),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert set(out) == {"arch", "batch", "decoded", "tokens_per_second",
                        "last_window_labels", "last_window_routing", "sample_output"}
    assert out["decoded"] == 8 and len(out["sample_output"]) == 8


#: the serve driver on two Gloo ranks under torchrun, against one process:
#: the dense family, the MoE (its blocks gather their tokens over `data`,
#: the experts' hidden dim split there), the SSM and the encoder-decoder
TORCHRUN_ARCHS = ["paper-gpt-125m", "phi3.5-moe-42b-a6.6b", "mamba2-130m", "whisper-base"]


@pytest.fixture(scope="module")
def torchrun_runs():
    """`torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve
    --device cpu --reduced` for each of `TORCHRUN_ARCHS`, all at once, and
    each one's one-process run in this process meanwhile."""
    env = dict(os.environ, OMP_NUM_THREADS="1")  # 8 ranks start at once and share the cores
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    argv = ["--reduced", "--batch", "4", "--prompt-len", "8", "--decode", "8", "--device", "cpu"]
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.serve", "--arch", arch, *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for arch in TORCHRUN_ARCHS}
    try:
        one = {arch: serve.run(serve.make_argparser().parse_args(["--arch", arch, *argv]))
               for arch in TORCHRUN_ARCHS}
        out = {}
        for arch, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stderr[-3000:]
            out[arch] = json.loads(stdout)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out, one


@pytest.mark.parametrize("arch", TORCHRUN_ARCHS)
def test_serve_driver_on_two_gloo_ranks_equals_one_process(torchrun_runs, arch):
    """On two ranks the driver places the caches and the prompts over
    `data` (`make_local_mesh()` over the group: (2, 1)); rank 0 prints the
    one JSON object, whose greedy tokens (row 0's, all 8 decoded) equal
    the one-process run's."""
    got, want = torchrun_runs[0][arch], torchrun_runs[1][arch]
    assert set(got) == set(want)
    assert got["decoded"] == want["decoded"] == 8
    assert got["sample_output"] == want["sample_output"]
    assert got["arch"] == want["arch"] and got["batch"] == want["batch"] == 4
