"""The PyTorch port's training path against the reference, on CPU.

Model (`repro_torch.models`), optimizer, train step, data pipeline,
checkpoint and the training driver.  Inputs are made with numpy from a
seed; the reference's `init_lm` weights are carried into the port with
`params_from_jax`, so both packages compute on the same numbers.
Tolerances (stated where used):
- logits: atol 1e-5, rtol 1e-5; loss: rtol 1e-6; every gradient: rtol
  1e-4, atol 1e-6 (f32, reduced configs);
- attention outputs: atol 1e-5, rtol 1e-5 in f32;
- one AdamW update: 99.9 % of parameter elements within 1e-6, all within
  2 x lr (an element whose gradient is near 0 may take Adam's first step,
  +-lr, with the other sign);
- three train steps: losses within rtol 1e-5;
- synthetic batches: bit for bit.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import SyntheticTokens as RefTokens  # noqa: E402
from repro.distributed.sharding import BASELINE_PLAN  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import build_train_step as ref_build_train_step  # noqa: E402
from repro.launch.steps import init_train_state as ref_init_train_state  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import ARCHITECTURES, get_config  # noqa: E402
from repro_torch.data import PrefetchPipeline, SyntheticTokens  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.distributed import sharding as port_sharding  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh as port_local_mesh  # noqa: E402
from repro_torch.launch.steps import build_train_step, init_train_state  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import chunked_causal_attention  # noqa: E402
from repro_torch.models.transformer import decay_mask, params_from_jax  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_updates, init_opt, lr_at  # noqa: E402

B, S = 2, 64

#: (arch, overrides of its reduced config): the paper model (gelu, LN,
#: qkv bias), a swiglu/RMS GQA model, an untied head, a padded vocab
#: (250 -> 256) and a sliding window over four chunks
CASES = {
    "paper-gpt": ("paper-gpt-125m", {}),
    "granite-gqa": ("granite-3-2b", {}),
    "phi3-untied": ("phi3-medium-14b", {}),
    "padded-vocab": ("paper-gpt-125m", {"vocab_size": 250}),
    "sliding": ("granite-3-2b", {"attention": "sliding", "window": 24,
                                 "attn_q_chunk": 16, "attn_kv_chunk": 16}),
}


def _configs(case):
    arch, extra = CASES[case]
    return (dataclasses.replace(ref_config(arch).reduced(), **extra),
            dataclasses.replace(get_config(arch).reduced(), **extra))


def _batch(vocab, seed=0, shape=(B, S)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[..., :5] = -1  # ignored positions
    return {"tokens": tokens, "labels": labels}


def _port_from_ref(ref_params, cfg):
    model = build_model(cfg)
    module = model.init(device="cpu")
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, ref_params), cfg))
    return model, module


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def model_case(request):
    rcfg, cfg = _configs(request.param)
    params = ref_tfm.init_lm(jax.random.PRNGKey(1), rcfg)
    batch = _batch(rcfg.vocab_size)
    logits, _ = ref_tfm.forward_lm(params, rcfg, jnp.asarray(batch["tokens"]))
    loss, grads = jax.value_and_grad(
        lambda p: ref_tfm.lm_loss(p, rcfg, jnp.asarray(batch["tokens"]),
                                  jnp.asarray(batch["labels"]))
    )(params)
    return dict(rcfg=rcfg, cfg=cfg, params=params, batch=batch,
                logits=np.asarray(logits), loss=float(loss), grads=grads)


class TestModel:
    def test_logits(self, model_case):
        model, module = _port_from_ref(model_case["params"], model_case["cfg"])
        with torch.no_grad():
            got = model.forward(module, _tensors(model_case["batch"])).numpy()
        assert got.shape == model_case["logits"].shape
        np.testing.assert_allclose(got, model_case["logits"], atol=1e-5, rtol=1e-5)

    def test_loss_and_every_gradient(self, model_case):
        cfg = model_case["cfg"]
        model, module = _port_from_ref(model_case["params"], cfg)
        loss = model.loss(module, _tensors(model_case["batch"]))
        assert float(loss.detach()) == pytest.approx(model_case["loss"], rel=1e-6)
        names = [n for n, _ in module.named_parameters()]
        grads = torch.autograd.grad(loss, list(module.parameters()))
        want = params_from_jax(jax.tree.map(np.asarray, model_case["grads"]), cfg)
        assert sorted(names) == sorted(want)
        for name, g in zip(names, grads):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)

    def test_tied_embedding_stays_tied(self, model_case):
        cfg = model_case["cfg"]
        _, module = _port_from_ref(model_case["params"], cfg)
        names = {n for n, _ in module.named_parameters()}
        assert ("head" in names) == (not cfg.tie_embeddings)
        np.testing.assert_array_equal(module.embed.detach().numpy(),
                                      np.asarray(model_case["params"]["embed"]))


def test_padded_vocab_columns_are_masked():
    rcfg, cfg = _configs("padded-vocab")
    assert cfg.padded_vocab > cfg.vocab_size
    _, module = _port_from_ref(ref_tfm.init_lm(jax.random.PRNGKey(1), rcfg), cfg)
    with torch.no_grad():
        logits = module(torch.from_numpy(_batch(cfg.vocab_size)["tokens"]))
    assert torch.all(logits[..., cfg.vocab_size:] == -1e9)
    assert torch.all(logits[..., :cfg.vocab_size] > -1e9)


@pytest.mark.parametrize("remat,attn_remat", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_remat_changes_nothing(remat, attn_remat):
    """Checkpointing a layer or an attention q-block recomputes the same
    numbers: loss and gradients equal the un-checkpointed model's exactly."""
    _, base = _configs("paper-gpt")
    batch = _tensors(_batch(base.vocab_size))

    def run(cfg):
        model = build_model(cfg)
        module = model.init(generator=torch.Generator().manual_seed(3), device="cpu")
        loss = model.loss(module, batch)
        return loss, torch.autograd.grad(loss, list(module.parameters()))

    want_loss, want = run(dataclasses.replace(base, remat=False, attn_remat=False))
    got_loss, got = run(dataclasses.replace(base, remat=remat, attn_remat=attn_remat))
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("s,q_chunk,kv_chunk,window,triangular", [
    (64, 64, 64, None, False),
    (64, 16, 16, None, False),
    (64, 16, 32, None, False),
    (64, 32, 16, None, True),
    (64, 16, 16, 24, False),
    (64, 16, 16, 24, True),
    (96, 32, 16, 40, True),
])
def test_chunked_causal_attention(s, q_chunk, kv_chunk, window, triangular):
    rng = np.random.default_rng(s + q_chunk + kv_chunk)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    kw = dict(q_chunk=q_chunk, kv_chunk=kv_chunk, window=window, triangular=triangular)
    want = np.asarray(ref_attention.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = chunked_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cast_f32", [True, False])
def test_attention_bf16_operands(cast_f32):
    """bf16 operands with f32 scores either way; cast_f32=False rounds the
    probabilities to bf16 before the PV product, as the reference does.
    The outputs are bf16: within one bf16 rounding (rtol 2**-7 relative
    to the largest output, atol 1e-2) of the reference's."""
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((2, 64, h, 16)).astype(np.float32) for h in (4, 2, 2)]
    kw = dict(q_chunk=16, kv_chunk=16, cast_f32=cast_f32)
    want = ref_attention.chunked_causal_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs), **kw)
    got = chunked_causal_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrs), **kw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=2**-7)


def test_other_families_raise():
    """No family raises any more: every family of ARCHITECTURES, encdec
    included, builds reduced on the CPU with its config's layer counts
    (encdec: its encoder and decoder stacks)."""
    families = set()
    for name, cfg in ARCHITECTURES.items():
        reduced = cfg.reduced()
        module = build_model(reduced).init(device="cpu")
        families.add(cfg.family)
        if cfg.family == "encdec":
            assert len(module.enc_layers) == reduced.n_enc_layers == 2, name
            assert len(module.dec_layers) == reduced.n_layers == 2, name
        else:
            assert len(module.layers) == reduced.n_layers, name
    assert families == {"dense", "moe", "ssm", "hybrid", "vlm", "encdec"}


def test_decay_mask_is_the_reference_rule_on_its_tree():
    """Under scan_layers every per-layer leaf of the reference is stacked
    [L, ...], so per-layer biases and norm scales are decayed and only the
    final norm is not; without it, 1-D leaves are not decayed."""
    for scan in (True, False):
        rcfg, cfg = _configs("paper-gpt")
        rcfg = dataclasses.replace(rcfg, scan_layers=scan)
        cfg = dataclasses.replace(cfg, scan_layers=scan)
        ref = jax.tree.map(lambda a: np.asarray(a).ndim >= 2,
                           ref_tfm.init_lm(jax.random.PRNGKey(0), rcfg))
        if scan:  # one flag per stacked leaf: repeat it per layer
            ref["layers"] = jax.tree.map(
                lambda f: np.full(cfg.n_layers, f), ref["layers"])
        want = {n: bool(t) for n, t in params_from_jax(
            jax.tree.map(np.asarray, ref), cfg).items()}
        module = build_model(cfg).init(device="cpu")
        assert decay_mask(module) == want


# ---------------------------------------------------------------------------
# Optimizer and train step
# ---------------------------------------------------------------------------


def test_lr_schedule():
    for cfg in (RefAdamWConfig(), RefAdamWConfig(warmup_steps=10, decay_steps=30)):
        port_cfg = AdamWConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 9999, 20000):
            want = float(ref_adamw.lr_at(cfg, jnp.asarray(step)))
            got = float(lr_at(port_cfg, torch.tensor(step)))
            assert got == pytest.approx(want, rel=1e-6), step


def _close_enough(got, want, lr):
    """99.9 % of elements within 1e-6, every element within 2 x lr."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * lr, diff.max()
    return np.count_nonzero(diff > 1e-6), diff.size


def test_one_adamw_update():
    rcfg, cfg = _configs("paper-gpt")
    params = ref_tfm.init_lm(jax.random.PRNGKey(1), rcfg)
    batch = _batch(rcfg.vocab_size)
    grads = jax.grad(lambda p: ref_tfm.lm_loss(
        p, rcfg, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])))(params)
    opt = RefAdamWConfig(peak_lr=1e-3, warmup_steps=1)
    want, _, want_m = ref_adamw.apply_updates(opt, params, grads,
                                              ref_adamw.init_opt(params))
    model, module = _port_from_ref(params, cfg)
    loss = model.loss(module, _tensors(batch))
    named = dict(module.named_parameters())
    port_grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    _, state, got_m = apply_updates(AdamWConfig(**dataclasses.asdict(opt)), named,
                                    port_grads, init_opt(named), decay_mask(module))
    assert int(state.count) == 1
    assert float(got_m["grad_norm"]) == pytest.approx(float(want_m["grad_norm"]), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, want), cfg)
    off = total = 0
    for name, p in named.items():
        o, t = _close_enough(p.detach().numpy(), want[name].numpy(), opt.peak_lr)
        off, total = off + o, total + t
    assert off <= 0.001 * total, (off, total)


def test_default_decay_is_by_dimension():
    params = {"w": torch.ones(2, 3), "b": torch.ones(3)}
    cfg = AdamWConfig(peak_lr=0.1, warmup_steps=1, weight_decay=0.5)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    apply_updates(cfg, params, zero, init_opt(params))
    assert torch.allclose(params["w"], torch.full((2, 3), 1 - 0.1 * 0.5))
    assert torch.equal(params["b"], torch.ones(3))


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps(accum):
    rcfg, cfg = _configs("paper-gpt")
    opt = RefAdamWConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    src = RefTokens(rcfg.vocab_size, 4, 32, seed=1)

    def host_batch(i):
        b = src.batch_at(i)
        return {k: v.reshape(accum, -1, *v.shape[1:]) if accum > 1 else v
                for k, v in b.items()}

    mesh = make_local_mesh()
    with mesh:
        ref_step, _ = ref_build_train_step(ref_build_model(rcfg), mesh, BASELINE_PLAN,
                                           opt, accum_steps=accum)
        state = ref_init_train_state(ref_build_model(rcfg), jax.random.PRNGKey(0))
        ref_params = jax.tree.map(np.asarray, state.params)
        want = []
        for i in range(3):
            state, m = ref_step(state, {k: jnp.asarray(v) for k, v in host_batch(i).items()})
            want.append(float(m["loss"]))
    model = build_model(cfg)
    port = init_train_state(model, device="cpu")
    port.params.load_state_dict(params_from_jax(ref_params, cfg))
    step, _ = build_train_step(model, port_local_mesh(device="cpu"),
                               port_sharding.BASELINE_PLAN,
                               AdamWConfig(**dataclasses.asdict(opt)), accum_steps=accum)
    got = []
    for i in range(3):
        port, m = step(port, _tensors(host_batch(i)))
        got.append(float(m["loss"]))
    assert int(port.step) == 3 and int(port.opt.count) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (1, 0, 1), (7, 1, 2), (3, 2, 4)])
def test_synthetic_tokens_equal_the_reference(seed, shard, num_shards):
    kw = dict(seed=seed, shard=shard, num_shards=num_shards)
    ref, port = RefTokens(50304, 3, 17, **kw), SyntheticTokens(50304, 3, 17, **kw)
    for cursor in (0, 1, 5, 1000, 2**40):
        a, b = ref.batch_at(cursor), port.batch_at(cursor)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


class TestDataPipeline:
    def test_prefetch_resume_from_cursor(self):
        src = SyntheticTokens(1000, 2, 8, seed=1)
        p1 = PrefetchPipeline(src, start_cursor=0)
        [next(p1) for _ in range(5)]
        state = p1.state()
        p1.close()
        p2 = PrefetchPipeline(src, start_cursor=state["cursor"])
        nxt = next(p2)
        p2.close()
        np.testing.assert_array_equal(nxt["tokens"], src.batch_at(5)["tokens"])

    def test_stall_injection(self):
        import time

        src = SyntheticTokens(100, 1, 4)
        p = PrefetchPipeline(src, prefetch=1, stall=lambda s: 0.2 if s == 3 else 0.0)
        next(p), next(p), next(p)
        t0 = time.perf_counter()
        next(p)  # batch 3 is produced only after its 0.2 s stall
        waited = time.perf_counter() - t0
        p.close()
        assert waited > 0.05, waited


# ---------------------------------------------------------------------------
# Checkpoint (the reference's TestCheckpoint / TestCheckpointEdges cases)
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.ones(4)]}
        save_checkpoint(str(tmp_path), 10, tree, extra={"cursor": 99})
        out = restore_checkpoint(str(tmp_path), tree)
        assert out is not None
        restored, extra, step = out
        assert step == 10 and extra["cursor"] == 99
        np.testing.assert_array_equal(restored["a"], tree["a"])

    def test_latest_and_prune(self, tmp_path):
        tree = {"x": np.zeros(2)}
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(str(tmp_path), s, tree, keep=3)
        assert latest_step(str(tmp_path)) == 5
        assert list_steps(str(tmp_path)) == [3, 4, 5]

    def test_corrupt_checkpoint_skipped(self, tmp_path):
        tree = {"x": np.arange(4.0)}
        save_checkpoint(str(tmp_path), 1, tree)
        p2 = save_checkpoint(str(tmp_path), 2, tree)
        with open(os.path.join(p2, "arrays.npz"), "wb") as f:
            f.write(b"garbage")
        out = restore_checkpoint(str(tmp_path), tree)
        assert out is not None and out[2] == 1  # fell back to step 1

    def test_tmp_dir_never_visible(self, tmp_path):
        save_checkpoint(str(tmp_path), 7, {"x": np.zeros(1)})
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))

    def test_restore_explicit_step(self, tmp_path):
        for s in (1, 2, 3):
            save_checkpoint(str(tmp_path), s, {"x": np.full(2, float(s))})
        out = restore_checkpoint(str(tmp_path), {"x": np.zeros(2)}, step=2)
        assert out is not None and out[2] == 2
        np.testing.assert_array_equal(out[0]["x"], np.full(2, 2.0))

    def test_restore_explicit_missing_step_returns_none(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"x": np.zeros(2)})
        assert restore_checkpoint(str(tmp_path), {"x": np.zeros(2)}, step=99) is None

    def test_template_leaf_count_mismatch_skips(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"x": np.arange(2.0)})
        save_checkpoint(str(tmp_path), 2, {"x": np.arange(2.0), "y": np.ones(1)})
        out = restore_checkpoint(str(tmp_path), {"x": np.zeros(2)})
        assert out is not None and out[2] == 1

    def test_empty_and_absent_root(self, tmp_path):
        assert restore_checkpoint(str(tmp_path), {"x": np.zeros(1)}) is None
        assert latest_step(str(tmp_path)) is None
        absent = str(tmp_path / "never_created")
        assert restore_checkpoint(absent, {"x": np.zeros(1)}) is None
        assert latest_step(absent) is None

    def test_restore_recasts_dtype_and_shape(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"x": np.arange(6, dtype=np.float64)})
        out = restore_checkpoint(str(tmp_path), {"x": np.zeros((2, 3), dtype=np.float32)})
        assert out is not None
        assert out[0]["x"].dtype == np.float32 and out[0]["x"].shape == (2, 3)

    def test_train_state_roundtrip_with_bf16(self, tmp_path):
        """A train state (bf16 weights, f32 moments, a NamedTuple) comes
        back exactly, in its template's dtypes, and keys in sorted order
        fix the leaf order whatever the dict's insertion order."""
        cfg = dataclasses.replace(get_config("paper-gpt-125m").reduced(),
                                  param_dtype="bfloat16", compute_dtype="bfloat16")
        model = build_model(cfg)
        state = init_train_state(model, torch.Generator().manual_seed(5), "cpu")
        step, _ = build_train_step(model, port_local_mesh(device="cpu"),
                                   port_sharding.BASELINE_PLAN, AdamWConfig(warmup_steps=1))
        state, _ = step(state, _tensors(_batch(cfg.vocab_size, shape=(2, 16))))
        save_checkpoint(str(tmp_path), 1, state.tree())
        fresh = init_train_state(model, torch.Generator().manual_seed(6), "cpu")
        template = fresh.tree()
        template["params"] = dict(reversed(list(template["params"].items())))
        tree, _, s = restore_checkpoint(str(tmp_path), template)
        fresh.load(tree)
        assert s == 1 and int(fresh.step) == 1 and int(fresh.opt.count) == 1
        for (n, p), (_, q) in zip(state.params.named_parameters(),
                                  fresh.params.named_parameters()):
            assert q.dtype == torch.bfloat16 and torch.equal(p, q), n
        for n in state.opt.mu:
            assert torch.equal(state.opt.mu[n], fresh.opt.mu[n])
            assert torch.equal(state.opt.nu[n], fresh.opt.nu[n])


# ---------------------------------------------------------------------------
# The driver (tests/test_integration.py's train tests, on the port)
# ---------------------------------------------------------------------------


class TestTrainDriver:
    """On the CPU the port's step computes inside its dispatch span, and a
    data stall shows only past what the prefetch holds (two queued
    batches and the one being made: ~3 steps).  The reference's 500 ms
    stall is sized for its jitted step of a few ms; the port's eager CPU
    step is far longer, so its stall is 3 s, past what the prefetch
    holds."""

    def _args(self, tmp_path, steps, extra=()):
        argv = [
            "--arch", "paper-gpt-125m", "--reduced",
            "--steps", str(steps), "--batch", "4", "--seq", "64",
            "--window", "10", "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
            "--resume", "auto", "--log-every", "1000", "--device", "cpu",
        ] + list(extra)
        return train.make_argparser().parse_args(argv)

    def test_loss_decreases_and_windows_labeled(self, tmp_path):
        summary = train.run(self._args(tmp_path, 30))
        assert summary["last_loss"] < summary["first_loss"]
        assert len(summary["windows"]) >= 2
        for w in summary["windows"]:
            assert "frontier_accounting" in w["labels"]
            assert abs(sum(w["shares"]) - 1.0) < 0.02

    def test_restart_resumes_from_checkpoint(self, tmp_path):
        train.run(self._args(tmp_path, 25))
        assert latest_step(str(tmp_path)) == 25
        summary2 = train.run(self._args(tmp_path, 40))
        assert summary2["steps"] == 15  # resumed at 25, ran to 40

    def test_resume_at_the_last_step_runs_nothing(self, tmp_path):
        """The reference raises here (ROADMAP.md C8); the port runs no
        step and reads no loss."""
        train.run(self._args(tmp_path, 10))
        summary = train.run(self._args(tmp_path, 10))
        assert summary["steps"] == 0 and summary["first_loss"] is None

    def test_policy_arms_a_ten_step_trace(self, tmp_path, monkeypatch):
        """A trigger_profiler action starts torch.profiler; ten steps later
        the trace is written to --profile-dir as a Chrome trace, and beside
        it the traced steps' regions: each interval's region, phase, host
        start on the trace's clock and device ms."""
        from repro_torch.distributed.policy import Action, MonitorPolicy

        fired = []

        def on_report(self, report):
            if fired:
                return []
            fired.append(report.window_index)
            return [Action(kind="trigger_profiler", window_index=report.window_index)]

        monkeypatch.setattr(MonitorPolicy, "on_report", on_report)
        prof_dir = tmp_path / "traces"
        summary = train.run(self._args(
            tmp_path / "ckpt", 30, extra=["--profile-dir", str(prof_dir)]))
        assert [a["kind"] for a in summary["actions"]] == ["trigger_profiler"]
        trace, regions = sorted(prof_dir.iterdir(), key=lambda p: p.name, reverse=True)
        assert trace.name == "trace_step19.json"  # armed at step 9, ten steps
        assert "traceEvents" in json.loads(trace.read_text())
        assert regions.name == "regions_step19.json"
        sidecar = json.loads(regions.read_text())
        assert sidecar["clock"] == "time.time_ns"
        assert [s["step"] for s in sidecar["steps"]] == list(range(10, 20))
        for s in sidecar["steps"]:
            starts = [i["host_start_ns"] for i in s["intervals"]]
            assert starts == sorted(starts) and starts[-1] <= s["host_end_ns"]
            assert {i["region"] for i in s["intervals"]} >= {
                "embed", "attention", "mlp", "head_loss", "optimizer"}
            assert all(i["device_ms"] >= 0 for i in s["intervals"])

    def test_data_stall_routes_to_data(self, tmp_path):
        summary = train.run(
            self._args(tmp_path, 30, extra=["--data-stall-ms", "3000"])
        )
        data_shares = [w["shares"][0] for w in summary["windows"][1:]]
        routed = [w["routing"][0] for w in summary["windows"] if w["routing"]]
        assert any(r == "data.next_wait" for r in routed) or max(
            data_shares, default=0.0
        ) > 0.3, summary["windows"]
