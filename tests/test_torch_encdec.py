"""The PyTorch port's encoder-decoder family (whisper-base) against the
reference, on CPU.

`full_cross_attention`, the sinusoid, the encoder, the teacher-forced
forward, the loss and every gradient, the decode caches and the decode
step, one train step, the serve driver and the train driver, all at
`whisper-base.reduced()` (2 + 2 layers, d 64, 4 heads on 2 KV heads,
vocab 256, f32).  The reference's `init_encdec` weights are carried into
the port with `params_from_jax`; inputs are made with numpy from a seed.
Tolerances (stated where used):
- attention: atol 1e-5, rtol 1e-5 in f32; in bf16 within one bf16
  rounding of the reference's (atol 1e-2, rtol 2**-7);
- sinusoid: atol 1e-6 (f32 sin and cos of angles up to 255);
- encoder states, logits, cross K/V, decode logits and caches: atol
  1e-5, rtol 1e-5; loss: rtol 1e-6; every gradient: rtol 1e-4, atol
  1e-6;
- one train step: loss rtol 1e-6, grad norm rtol 1e-5, 99.9 % of
  parameter elements within 1e-6 and all within 2 x lr;
- greedy tokens and the serve driver's sample: equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed.sharding import BASELINE_PLAN  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import build_train_step as ref_build_train_step  # noqa: E402
from repro.launch.steps import init_train_state as ref_init_train_state  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.distributed import sharding as port_sharding  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh as port_local_mesh  # noqa: E402
from repro_torch.launch.steps import build_train_step, init_train_state  # noqa: E402
from repro_torch.models import build_model, encdec  # noqa: E402
from repro_torch.models.attention import full_cross_attention  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    TransformerLM,
    decay_mask,
    params_from_jax,
)
from repro_torch.optim import AdamWConfig  # noqa: E402

ARCH = "whisper-base"
B, S = 2, 64  # two of the reduced config's 32-token attention chunks
T_ENC = S // 4


def _configs(**extra):
    return (dataclasses.replace(ref_config(ARCH).reduced(), **extra),
            dataclasses.replace(get_config(ARCH).reduced(), **extra))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(params, cfg):
    model = build_model(cfg)
    module = model.init(device="cpu")
    module.load_state_dict(params_from_jax(_np(params), cfg))
    return model, module


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :4] = -1  # ignored positions
    frames = rng.standard_normal((B, T_ENC, cfg.d_model)).astype(np.float32)
    return {"frames": frames, "tokens": tokens, "labels": labels}


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Attention and positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 4), (8, 1)])
def test_full_cross_attention(heads, kv_heads, dtype):
    """11 queries against 24 keys, grouped GQA and not: f32 scores,
    softmax and PV whatever the operands' dtype, the output in q's.
    f32: atol/rtol 1e-5; bf16: one bf16 rounding (atol 1e-2, rtol 2**-7)."""
    rng = np.random.default_rng(heads * 10 + kv_heads)
    q = rng.standard_normal((2, 11, heads, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, kv_heads, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, kv_heads, 16)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = ref_attention.full_cross_attention(*(jnp.asarray(a, jd) for a in (q, k, v)))
    got = full_cross_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert got.dtype == td and got.shape == (2, 11, heads, 16)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=2**-7)


@pytest.mark.parametrize("seq,d", [(1, 64), (16, 64), (256, 512)])
def test_sinusoidal_positions(seq, d):
    """[sin, cos] concatenated, f32, within 1e-6 of the reference's at
    positions up to 255."""
    want = np.asarray(ref_encdec.sinusoidal_positions(seq, d))
    got = encdec.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and got.shape == want.shape == (seq, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if seq == 1:  # position 0: sin 0 then cos 0
        np.testing.assert_array_equal(got.numpy()[0], [0.0] * (d // 2) + [1.0] * (d // 2))


# ---------------------------------------------------------------------------
# The model: encoder, forward, loss and every gradient
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[True, False], ids=["scan", "list"])
def model_case(request):
    """The reference's stacked (scan_layers) or listed tree, its logits,
    loss and gradients on one frames batch."""
    rcfg, cfg = _configs(scan_layers=request.param)
    params = ref_encdec.init_encdec(jax.random.PRNGKey(1), rcfg)
    batch = _batch(cfg)
    jb = _jnp(batch)
    enc = ref_encdec.encode(params, rcfg, jb["frames"])
    logits = ref_encdec.forward_encdec(params, rcfg, jb["frames"], jb["tokens"])
    loss, grads = jax.value_and_grad(lambda p: ref_encdec.encdec_loss(
        p, rcfg, jb["frames"], jb["tokens"], jb["labels"]))(params)
    model, module = _port(params, cfg)
    return dict(rcfg=rcfg, cfg=cfg, params=params, batch=batch, model=model,
                module=module, enc=np.asarray(enc), logits=np.asarray(logits),
                loss=float(loss), grads=grads)


class TestModel:
    def test_parameter_names_and_shapes(self, model_case):
        """The reference's leaves, one parameter each, nothing more."""
        c = model_case
        want = params_from_jax(_np(c["params"]), c["cfg"])
        got = dict(c["module"].named_parameters())
        assert {n: tuple(p.shape) for n, p in got.items()} == {
            n: tuple(t.shape) for n, t in want.items()}
        assert "dec_layers.1.cross.wk" in got and "enc_layers.1.attn.wq" in got
        assert "bq" not in {n.split(".")[-1] for n in got}  # no qkv bias

    def test_encode(self, model_case):
        c = model_case
        with torch.no_grad():
            got = c["module"].encode(torch.from_numpy(c["batch"]["frames"]))
        assert got.shape == c["enc"].shape == (B, T_ENC, c["cfg"].d_model)
        np.testing.assert_allclose(got.numpy(), c["enc"], atol=1e-5, rtol=1e-5)

    def test_logits(self, model_case):
        c = model_case
        with torch.no_grad():
            got = c["model"].forward(c["module"], _tensors(c["batch"])).numpy()
        assert got.shape == c["logits"].shape == (B, S, c["cfg"].padded_vocab)
        np.testing.assert_allclose(got, c["logits"], atol=1e-5, rtol=1e-5)

    def test_loss_and_every_gradient(self, model_case):
        c = model_case
        module, cfg = c["module"], c["cfg"]
        loss = c["model"].loss(module, _tensors(c["batch"]))
        assert float(loss.detach()) == pytest.approx(c["loss"], rel=1e-6)
        names = [n for n, _ in module.named_parameters()]
        grads = torch.autograd.grad(loss, list(module.parameters()))
        want = params_from_jax(_np(c["grads"]), cfg)
        assert sorted(names) == sorted(want)
        for name, g in zip(names, grads):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)

    def test_decay_mask_is_the_reference_rule_on_its_tree(self, model_case):
        """Under scan_layers every per-layer leaf of both stacks is
        stacked [L, ...] and decayed, so only the two final norms escape;
        without it every 1-D leaf escapes."""
        c = model_case
        cfg = c["cfg"]
        ref = jax.tree.map(lambda a: np.asarray(a).ndim >= 2, c["params"])
        if cfg.scan_layers:  # one flag per stacked leaf: repeat it per layer
            for key, n in (("enc_layers", cfg.n_enc_layers), ("dec_layers", cfg.n_layers)):
                ref[key] = jax.tree.map(lambda f, n=n: np.full(n, f), ref[key])
        want = {n: bool(t) for n, t in params_from_jax(_np(ref), cfg).items()}
        got = decay_mask(c["module"])
        assert got == want
        escaped = sorted(n for n, d in got.items() if not d)
        if cfg.scan_layers:
            assert escaped == ["dec_final_norm.bias", "dec_final_norm.scale",
                               "enc_final_norm.bias", "enc_final_norm.scale"]
        else:
            assert "enc_layers.0.attn_norm.scale" in escaped
            assert "dec_layers.1.cross_norm.bias" in escaped


def test_triangular_forward():
    """``triangular=True`` skips the causal attention's masked KV chunks:
    the same logits as the reference's (atol/rtol 1e-5)."""
    rcfg, cfg = _configs()
    params = ref_encdec.init_encdec(jax.random.PRNGKey(4), rcfg)
    batch = _batch(cfg, seed=4)
    jb = _jnp(batch)
    want = ref_encdec.forward_encdec(params, rcfg, jb["frames"], jb["tokens"],
                                     triangular=True)
    model, module = _port(params, cfg)
    with torch.no_grad():
        got = model.forward(module, _tensors(batch), triangular=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_changes_nothing(remat):
    """Checkpointing each encoder and decoder layer (the full config's
    ``remat=True``) recomputes the same numbers: loss and gradients equal
    the un-checkpointed model's exactly."""
    _, base = _configs()
    batch = _tensors(_batch(base))

    def run(cfg):
        model = build_model(cfg)
        module = model.init(generator=torch.Generator().manual_seed(3), device="cpu")
        loss = model.loss(module, batch)
        return loss, torch.autograd.grad(loss, list(module.parameters()))

    want_loss, want = run(dataclasses.replace(base, remat=False))
    got_loss, got = run(dataclasses.replace(base, remat=remat))
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_whisper_base_full_config_builds_its_shapes():
    """The full config's leaves, on the meta device (no memory): 6 + 6
    layers, d 512, 8 heads, d_ff 2,048, the vocab padded to 51,968 and
    tied; 3.15 M parameters an encoder layer, 4.20 M a decoder layer."""
    cfg = get_config(ARCH)
    assert (cfg.scan_layers, cfg.remat, cfg.cache_layout) == (True, True, "bskd")
    module = build_model(cfg).init(device="meta")
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert shapes["embed"] == (51968, 512)
    assert len(module.enc_layers) == len(module.dec_layers) == 6
    assert shapes["dec_layers.5.cross.wq"] == (512, 512)
    assert shapes["enc_layers.0.mlp.wi"] == (512, 2048)
    per_enc = sum(p.numel() for p in module.enc_layers[0].parameters())
    per_dec = sum(p.numel() for p in module.dec_layers[0].parameters())
    assert (per_enc, per_dec) == (3_150_336, 4_199_936)
    assert "head" not in shapes


def test_transformer_lm_refuses_the_family():
    with pytest.raises(ValueError, match="EncDecLM"):
        TransformerLM(get_config(ARCH).reduced(), device="cpu")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

DECODE_STEPS = 12


def _decode_case(seed=3, **extra):
    rcfg, cfg = _configs(**extra)
    params = ref_encdec.init_encdec(jax.random.PRNGKey(seed), rcfg)
    model, module = _port(params, cfg)
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, T_ENC, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (DECODE_STEPS, B, 1)).astype(np.int32)
    return rcfg, cfg, params, model, module, frames, tokens


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "list"])
def test_init_caches(scan):
    """Cross K/V of one encoder pass, [L, B, T_enc, KV, D] (atol/rtol
    1e-5), the self-attention caches zero [L, B, seq, KV, D] in the
    compute dtype; without frames, zero frames of seq / 4 positions, as
    the reference's `init_caches`."""
    rcfg, cfg, params, model, module, frames, _ = _decode_case(scan_layers=scan)
    want = ref_encdec.init_encdec_caches(params, rcfg, jnp.asarray(frames), DECODE_STEPS)
    got = model.init_caches(module, B, DECODE_STEPS, frames=torch.from_numpy(frames))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert got["cross_k"].shape == (cfg.n_layers, B, T_ENC, cfg.n_kv_heads, cfg.head_dim)
    for name in ("k", "v"):
        assert got[name].dtype == torch.float32 and not got[name].any()
    for name in ("cross_k", "cross_v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    seq = 40  # no frames: zeros [B, 10, D]
    want = ref_build_model(rcfg).init_caches(params, B, seq)
    got = model.init_caches(module, B, seq)
    assert got["cross_k"].shape[2] == want["cross_k"].shape[2] == seq // 4
    np.testing.assert_allclose(got["cross_v"].numpy(), np.asarray(want["cross_v"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "list"])
def test_decode_step_teacher_forced(scan):
    """12 steps of `decode_step` against the reference's
    `decode_step_encdec` on the same tokens: logits at every step and
    the caches at the end (atol/rtol 1e-5); the caches are written in
    place and the cross K/V never change."""
    rcfg, cfg, params, model, module, frames, tokens = _decode_case(scan_layers=scan)
    ref_caches = ref_encdec.init_encdec_caches(params, rcfg, jnp.asarray(frames),
                                               DECODE_STEPS)
    ref_step = jax.jit(lambda c, t, i: ref_encdec.decode_step_encdec(params, rcfg, c, t, i))
    caches = model.init_caches(module, B, DECODE_STEPS, frames=torch.from_numpy(frames))
    cross = {k: caches[k].clone() for k in ("cross_k", "cross_v")}
    for i, t in enumerate(tokens):
        want, ref_caches = ref_step(ref_caches, jnp.asarray(t), jnp.int32(i))
        got, out = model.decode_step(module, caches, torch.from_numpy(t), i, DECODE_STEPS)
        assert out is caches
        assert got.shape == (B, 1, cfg.padded_vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {i}")
    for name, c in caches.items():
        np.testing.assert_allclose(c.numpy(), np.asarray(ref_caches[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    for name, c in cross.items():
        assert torch.equal(caches[name], c), name


def test_decode_parts_from_the_forward_after_position_zero_in_both():
    """Decode adds the sinusoid of position 0 at every step (`ROADMAP.md`
    §C), so in both packages decode logits equal the teacher-forced
    forward's at position 0 (1e-5) and part from them from position 1 on
    (by more than 1e-2 at every later position); the two packages' gaps
    agree to 1e-5."""
    rcfg, cfg, params, model, module, frames, tokens = _decode_case(seed=5)
    seq = tokens[:, :, 0].T  # [B, steps]
    ref_full = np.asarray(ref_encdec.forward_encdec(
        params, rcfg, jnp.asarray(frames), jnp.asarray(seq)))
    with torch.no_grad():
        full = module(torch.from_numpy(frames), torch.from_numpy(seq)).numpy()
    ref_caches = ref_encdec.init_encdec_caches(params, rcfg, jnp.asarray(frames),
                                               DECODE_STEPS)
    caches = model.init_caches(module, B, DECODE_STEPS, frames=torch.from_numpy(frames))
    ref_dec, dec = [], []
    for i, t in enumerate(tokens):
        logits, ref_caches = ref_encdec.decode_step_encdec(
            params, rcfg, ref_caches, jnp.asarray(t), jnp.int32(i))
        ref_dec.append(np.asarray(logits)[:, 0])
        dec.append(model.decode_step(module, caches, torch.from_numpy(t), i,
                                     DECODE_STEPS)[0].numpy()[:, 0])
    ref_gap = np.stack(ref_dec, axis=1) - ref_full  # [B, steps, V]
    gap = np.stack(dec, axis=1) - full
    for g in (ref_gap, gap):
        part = np.abs(g[..., :cfg.vocab_size]).max(axis=(0, 2))
        assert part[0] < 1e-5, part
        assert (part[1:] > 1e-2).all(), part
    np.testing.assert_allclose(gap, ref_gap, atol=1e-5, rtol=1e-5)


def test_greedy_serve_loop_equals_the_reference():
    """The prompt fed token by token through the serve step, then 16
    greedy tokens, against the reference's `model.decode_step` loop on
    the same frames, prompts and weights: equal tokens."""
    rcfg, cfg = _configs()
    b, p, n = 3, 8, 16
    seq = p + n
    ref_model, model = ref_build_model(rcfg), build_model(cfg)
    params = ref_model.init(jax.random.PRNGKey(5))
    _, module = _port(params, cfg)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    frames = rng.standard_normal((b, seq // 4, cfg.d_model)).astype(np.float32)
    ref_step = jax.jit(lambda c, t, i: ref_model.decode_step(params, c, t, i, seq))
    ref_caches = ref_model.init_caches(params, b, seq, frames=jnp.asarray(frames))
    caches = model.init_caches(module, b, seq, frames=torch.from_numpy(frames))
    for i in range(p):
        ref_logits, ref_caches = ref_step(ref_caches, jnp.asarray(prompts[:, i:i + 1]),
                                          jnp.int32(i))
        logits, caches = model.decode_step(module, caches,
                                           torch.from_numpy(prompts[:, i:i + 1]), i, seq)
    want, got = [], []
    for j in range(n):
        ref_tok = jnp.argmax(ref_logits[:, -1:, :], axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
        want.append(np.asarray(ref_tok)[:, 0])
        got.append(tok[:, 0].numpy())
        ref_logits, ref_caches = ref_step(ref_caches, ref_tok, jnp.int32(p + j))
        logits, caches = model.decode_step(module, caches, tok, p + j, seq)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------


def _close_enough(got, want, lr):
    """Elements off by more than 1e-6; every element within 2 x lr (an
    element whose gradient is near 0 may take Adam's first step, +-lr,
    with the other sign)."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * lr, diff.max()
    return np.count_nonzero(diff > 1e-6), diff.size


def test_one_train_step():
    """The port's `build_train_step` on a frames batch against the
    reference's (its decay rule on its stacked tree, so both stacks'
    norms decay): loss, grad norm and the updated parameters."""
    rcfg, cfg = _configs()
    opt = RefAdamWConfig(peak_lr=1e-3, warmup_steps=1, weight_decay=0.1)
    batch = _batch(cfg, seed=6)
    mesh = make_local_mesh()
    with mesh:
        ref_step, _ = ref_build_train_step(ref_build_model(rcfg), mesh, BASELINE_PLAN, opt)
        state = ref_init_train_state(ref_build_model(rcfg), jax.random.PRNGKey(0))
        start = _np(state.params)
        state, m = ref_step(state, _jnp(batch))
        want_params = _np(state.params)
        want_loss, want_norm = float(m["loss"]), float(m["grad_norm"])
    model = build_model(cfg)
    port = init_train_state(model, device="cpu")
    port.params.load_state_dict(params_from_jax(start, cfg))
    step, _ = build_train_step(model, port_local_mesh(device="cpu"),
                               port_sharding.BASELINE_PLAN,
                               AdamWConfig(**dataclasses.asdict(opt)))
    port, got = step(port, _tensors(batch))
    assert int(port.step) == 1
    assert float(got["loss"]) == pytest.approx(want_loss, rel=1e-6)
    assert float(got["grad_norm"]) == pytest.approx(want_norm, rel=1e-5)
    want = params_from_jax(want_params, cfg)
    off = total = 0
    for name, p in port.params.named_parameters():
        o, t = _close_enough(p.detach().numpy(), want[name].numpy(), opt.peak_lr)
        off, total = off + o, total + t
    assert off <= 0.001 * total, (off, total)
    mask = decay_mask(port.params)
    assert mask["enc_layers.0.attn_norm.scale"] and mask["dec_layers.1.cross_norm.bias"]
    assert not mask["dec_final_norm.scale"]


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------


def _serve_args():
    return ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "8",
            "--decode", "8"]


def test_serve_run_equals_the_reference_run():
    """`launch/serve.run` on the CPU, handed the reference run's weights
    (PRNGKey(0)) and prompts, zero frames in both: the reference's JSON
    keys, `decoded`, and its sample of greedy tokens."""
    argv = _serve_args()
    want = ref_serve.run(ref_serve.make_argparser().parse_args(argv))
    rcfg, cfg = _configs()
    rng = jax.random.PRNGKey(0)
    params = ref_build_model(rcfg).init(rng)
    prompts = np.array(jax.random.randint(rng, (2, 8), 0, rcfg.vocab_size))
    got = serve.run(serve.make_argparser().parse_args(argv + ["--device", "cpu"]),
                    params=params_from_jax(_np(params), cfg), prompts=prompts)
    assert set(got) == set(want)
    assert got["decoded"] == want["decoded"] == 8
    assert got["sample_output"] == want["sample_output"]
    assert got["arch"] == want["arch"] == ARCH and got["batch"] == want["batch"]


def test_serve_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the driver would serve on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(serve.make_argparser().parse_args(_serve_args()))


def test_train_driver_fails_on_the_family_as_the_reference_does(tmp_path):
    """The synthetic pipeline yields tokens and labels only and the
    family's loss reads ``frames``: both drivers end in KeyError
    ('frames') at the first step (`ROADMAP.md` §C)."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "32", "--window", "10", "--log-every", "1000"]
    with pytest.raises(KeyError, match="frames"):
        ref_train.run(ref_train.make_argparser().parse_args(argv))
    with pytest.raises(KeyError, match="frames"):
        train.run(train.make_argparser().parse_args(argv + ["--device", "cpu"]))
