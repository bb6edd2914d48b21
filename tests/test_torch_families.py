"""The PyTorch port's MoE, SSM, hybrid and VLM families against the
reference, on CPU.

The mixers (`models/ssm.py`, `models/moe.py`) and the whole model of
each family, from the reference's weights carried across with
`params_from_jax`; inputs are made with numpy from a seed.  All f32,
reduced configs.  Tolerances (stated where used):
- `apply_moe` (y, aux): atol 1e-5, rtol 1e-5;
- `apply_ssm` and `decode_ssm`: atol 1e-5, rtol 1e-4 (exponentials of
  cumulative sums amplify differences in the order of the additions);
- logits: atol 1e-5, rtol 1e-5 (moe, vlm) and atol 1e-5, rtol 1e-4 (ssm,
  hybrid); loss: rtol 1e-6; every gradient: rtol 1e-4, atol 1e-6.

The tensor-parallel splits' plain versions, in one process, against the
whole forms: `split_ssm` (the scan on each rank's slice of d_inner, the
norm's sums of squares summed) against `apply_ssm`, atol 1e-6, rtol 1e-6
(the norm's sum over slices rounds otherwise than its mean over the
whole); `query_split_attention` against `chunked_causal_attention`, bit
for bit where a rank's blocks are the whole walk's (else atol 1e-6,
rtol 1e-6), and against `full_cross_attention`, atol 1e-6, rtol 1e-6;
the zigzag's cover and balance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import attention, moe, ssm  # noqa: E402
from repro_torch.models.transformer import decay_mask, params_from_jax  # noqa: E402

B, S = 2, 32

FAMILIES = {
    "moe": "phi3.5-moe-42b-a6.6b",
    "ssm": "mamba2-130m",
    "hybrid": "hymba-1.5b",
    "vlm": "internvl2-1b",
}


def _configs(arch, **extra):
    return (dataclasses.replace(ref_config(arch).reduced(), **extra),
            dataclasses.replace(get_config(arch).reduced(), **extra))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, tree):
    """Copy a reference subtree (leaf name -> array) into `module`."""
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in _np(tree).items()})
    return module


# ---------------------------------------------------------------------------
# The SSD mixer
# ---------------------------------------------------------------------------


def _ssm_pair(seed=0):
    rcfg, cfg = _configs("mamba2-130m")
    params = ref_ssm.init_ssm(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    # non-trivial A, D and dt so the decays differ per head
    rng = np.random.default_rng(seed)
    h = rcfg.ssm_n_heads
    params = dict(params,
                  A_log=jnp.asarray(rng.normal(0, 0.5, h), jnp.float32),
                  D=jnp.asarray(rng.normal(1, 0.3, h), jnp.float32),
                  dt_bias=jnp.asarray(rng.normal(0, 0.5, h), jnp.float32))
    mod = _load(ssm.SSM(cfg, torch.float32, "cpu", torch.Generator()), params)
    return rcfg, cfg, params, mod


@pytest.mark.parametrize("s", [16, 64], ids=["one-chunk", "four-chunks"])
def test_apply_ssm(s):
    """The chunked SSD over one chunk and several (atol 1e-5, rtol 1e-4)."""
    rcfg, cfg, params, mod = _ssm_pair()
    x = np.random.default_rng(1).standard_normal((B, s, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_ssm.apply_ssm(params, jnp.asarray(x), rcfg))
    with torch.no_grad():
        got = ssm.apply_ssm(mod, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_apply_ssm_keeps_the_chunk_assertion():
    rcfg, cfg, params, mod = _ssm_pair()
    with pytest.raises(AssertionError, match="ssm_chunk"):
        ssm.apply_ssm(mod, torch.zeros(1, 24, cfg.d_model), cfg)


#: d_inner 192 in 6 heads of 32 (the Gloo cases' split scan), the reduced
#: mamba2's 128 in 8 heads of 16, and hymba's
SPLIT_SSM = {"split-scan": ("mamba2-130m", {"ssm_expand": 3, "ssm_head_dim": 32}),
             "mamba2": ("mamba2-130m", {}), "hybrid": ("hymba-1.5b", {})}


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(SPLIT_SSM))
def test_split_ssm_equals_the_whole_scan(case, parts):
    """`split_ssm` over `parts` slices of d_inner (a slice a head and a
    half, half a head, or several heads) against `apply_ssm`, and
    against the reference's, over four chunks; each slice's scan touches
    at most its own channels' heads plus two."""
    arch, extra = SPLIT_SSM[case]
    rcfg, cfg = _configs(arch, **extra)
    rng = np.random.default_rng(2)
    h = cfg.ssm_n_heads
    params = dict(ref_ssm.init_ssm(jax.random.PRNGKey(0), rcfg, jnp.float32),
                  A_log=jnp.asarray(rng.normal(0, 0.5, h), jnp.float32),
                  D=jnp.asarray(rng.normal(1, 0.3, h), jnp.float32),
                  dt_bias=jnp.asarray(rng.normal(0, 0.5, h), jnp.float32),
                  gate_norm_scale=jnp.asarray(rng.normal(1, 0.1, cfg.ssm_d_inner),
                                              jnp.float32))
    mod = _load(ssm.SSM(cfg, torch.float32, "cpu", torch.Generator()), params)
    x = rng.standard_normal((B, 64, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        whole = ssm.apply_ssm(mod, torch.from_numpy(x), cfg)
        got = ssm.split_ssm(mod, torch.from_numpy(x), cfg, parts)
    torch.testing.assert_close(got, whole, atol=1e-6, rtol=1e-6)
    want = np.asarray(ref_ssm.apply_ssm(params, jnp.asarray(x), rcfg))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    width, hp = cfg.ssm_d_inner // parts, cfg.ssm_head_dim
    for r in range(parts):
        h0, h1 = ssm.channel_heads(r * width, (r + 1) * width, hp)
        assert h0 * hp <= r * width and (r + 1) * width <= h1 * hp
        assert (h1 - h0) * hp <= width + 2 * hp


#: GQA groups of 1, 3 and 5: (query heads, kv heads)
GROUPS = {1: (2, 2), 3: (6, 2), 5: (5, 1)}


@pytest.mark.parametrize("parts", [2, 4, 16])
@pytest.mark.parametrize("window", [None, 20], ids=["causal", "window-20"])
@pytest.mark.parametrize("triangular", [False, True], ids=["full-walk", "triangular"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_query_split_equals_the_whole_causal_attention(group, triangular, window, parts):
    """128 positions in chunks of 16 over `parts` ranks in zigzag: 2 and
    4 ranks take whole 16-row blocks and equal the whole walk bit for
    bit; 16 ranks' 8 rows are halved to two 4-row blocks each (atol
    1e-6, rtol 1e-6)."""
    h, kv = GROUPS[group]
    rng = np.random.default_rng(group)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 128, n, 16)).astype(np.float32))
               for n in (h, kv, kv))

    def core(q_, k_, v_, q_blocks=None, q_chunk=16):
        return attention.chunked_causal_attention(
            q_, k_, v_, q_chunk=q_chunk, kv_chunk=16, window=window, triangular=triangular,
            remat_qblock=False, q_blocks=q_blocks)

    whole = core(q, k, v)
    got = attention.query_split_attention(core, q, k, v, parts, q_chunk=16)
    size = attention.query_split(128, parts, 16)[0]
    assert size == (16 if parts < 16 else 4)
    if size == 16:
        assert torch.equal(got, whole)
    else:
        torch.testing.assert_close(got, whole, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_query_split_equals_the_whole_bidirectional_attention(group, parts):
    """96 queries over 40 keys in `parts` contiguous row blocks."""
    h, kv = GROUPS[group]
    rng = np.random.default_rng(10 + group)
    q = torch.from_numpy(rng.standard_normal((2, 96, h, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, kv, 16)).astype(np.float32))
            for _ in range(2))
    whole = attention.full_cross_attention(q, k, v)
    got = attention.query_split_attention(attention.full_cross_attention, q, k, v, parts)
    torch.testing.assert_close(got, whole, atol=1e-6, rtol=1e-6)
    assert attention.query_split(96, parts, None) == (96 // parts, [[r] for r in range(parts)])


@pytest.mark.parametrize("s,parts,q_chunk,kv_chunk", [
    (256, 2, 32, 32), (256, 4, 32, 32), (1024, 4, 64, 32), (512, 8, 32, 64),
    (32768, 16, 1024, 1024), (16384, 16, 1024, 1024), (8192, 16, 1024, 1024)])
def test_zigzag_covers_each_block_once_and_balances_the_triangular_walk(
        s, parts, q_chunk, kv_chunk):
    """Each query block goes to one rank; under `triangular` (no window)
    every rank's blocks walk as many KV chunks, so rank 0, which the dry
    run counts, does the busiest rank's work."""
    size, order = attention.query_split(s, parts, q_chunk)
    assert sorted(i for blocks in order for i in blocks) == list(range(s // size))
    assert len({len(blocks) for blocks in order}) == 1 and len(order[0]) % 2 == 0
    walked = [sum(len(attention.kv_chunks(i, size, kv_chunk, s // kv_chunk, None, True))
                  for i in blocks) for blocks in order]
    assert len(set(walked)) == 1, walked
    assert attention.zigzag_blocks(8, 4) == [[0, 7], [1, 6], [2, 5], [3, 4]]


def test_query_split_refuses_what_does_not_divide():
    assert attention.query_split(100, 16, 32) is None
    assert attention.query_split(96, 16, None) == (6, [[r] for r in range(16)])
    assert attention.query_split(96, 2, 32) is None  # 48 rows a rank: no whole 32-row blocks


def test_decode_ssm():
    """Twenty recurrent steps: outputs and both caches (atol 1e-5, rtol
    1e-4)."""
    rcfg, cfg, params, mod = _ssm_pair(seed=2)
    xs = np.random.default_rng(3).standard_normal((20, B, 1, cfg.d_model)).astype(np.float32)
    rc = ref_ssm.init_ssm_cache(rcfg, B)
    pc = ssm.init_ssm_cache(cfg, B, "cpu")
    assert {k: tuple(v.shape) for k, v in pc.items()} == {
        k: v.shape for k, v in rc.items()}
    assert all(v.dtype == torch.float32 for v in pc.values())
    for x in xs:
        want, rc = ref_ssm.decode_ssm(params, rc, jnp.asarray(x), rcfg)
        with torch.no_grad():
            got, pc = ssm.decode_ssm(mod, pc, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    for k in pc:
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# The expert block
# ---------------------------------------------------------------------------


def _moe_case(top_k, tokens, group, skew=False, seed=0):
    rcfg, cfg = _configs("phi3.5-moe-42b-a6.6b", top_k=top_k, moe_group=group)
    params = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, tokens, cfg.d_model)).astype(np.float32)
    if skew:  # every token prefers expert 0: more than `cap` of them
        x = np.abs(x)
        router = np.array(params["router"])
        router[:, 0] = 1.0
        params = dict(params, router=jnp.asarray(router))
    mod = _load(moe.MoE(cfg, torch.float32, "cpu", torch.Generator()), params)
    return rcfg, cfg, params, mod, x


MOE_CASES = {
    "top1": dict(top_k=1, tokens=64, group=64),
    "top2": dict(top_k=2, tokens=64, group=64),
    "top2-groups": dict(top_k=2, tokens=48, group=16),
    # 26 tokens in groups of 16: the last group has 6 zero rows, whose
    # gates tie across every expert
    "top2-padded": dict(top_k=2, tokens=26, group=16),
    "top1-padded": dict(top_k=1, tokens=21, group=8),
    "top2-overflow": dict(top_k=2, tokens=32, group=32, skew=True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe(case):
    """(y, aux) against the reference (atol 1e-5, rtol 1e-5)."""
    rcfg, cfg, params, mod, x = _moe_case(**MOE_CASES[case])
    want_y, want_aux = ref_moe.apply_moe(params, jnp.asarray(x), rcfg)
    with torch.no_grad():
        got_y, got_aux = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-5, abs=1e-6)


def test_moe_overflow_drops_in_the_reference_too():
    """The overflow case really drops: the reference's output with room
    for every token differs from its output at the configured capacity
    (more than `cap` of 32 tokens pick expert 0, cap = 20)."""
    rcfg, cfg, params, mod, x = _moe_case(**MOE_CASES["top2-overflow"])
    assert moe.capacity(32, cfg) == 20
    y = np.asarray(ref_moe.apply_moe(params, jnp.asarray(x), rcfg)[0])
    roomy = dataclasses.replace(rcfg, capacity_factor=100.0)
    y_all = np.asarray(ref_moe.apply_moe(params, jnp.asarray(x), roomy)[0])
    dropped = np.abs(y - y_all).max(axis=-1) > 1e-6
    assert dropped.sum() >= 32 - 20
    # the port counts what the reference drops: every token's slot 0 is
    # expert 0 (32 assignments for 20 slots), its slot 1 spread elsewhere
    with torch.no_grad():
        gates = torch.softmax(torch.from_numpy(x[0]) @ mod.router, dim=-1)
    per_expert = np.bincount(moe.top_k(gates, 2)[1].numpy().ravel(), minlength=4)
    want = int(np.clip(per_expert - 20, 0, None).sum())
    assert want >= 32 - 20
    assert int(moe.dropped(mod, torch.from_numpy(x), cfg)) == want
    assert int(moe.dropped(mod, torch.from_numpy(x), dataclasses.replace(
        cfg, capacity_factor=100.0))) == 0


def test_moe_top_k_orders_ties_as_the_reference():
    """Equal gates put the lower expert first, as `jax.lax.top_k` does: a
    zero (padding) row's gates are all equal, so its top k are experts
    0..k-1 and the aux loss reads expert 0; partial ties too."""
    rcfg, cfg, params, mod, x = _moe_case(**MOE_CASES["top2-padded"])
    with torch.no_grad():
        pad = torch.softmax(torch.zeros(1, cfg.d_model) @ mod.router, dim=-1)
    assert torch.all(pad == pad[0, 0])
    rng = np.random.default_rng(0)
    gates = np.concatenate([
        pad.numpy(),
        rng.integers(0, 3, (64, 4)).astype(np.float32) / 4,  # many ties
        rng.random((8, 4)).astype(np.float32),
    ])
    for k in (1, 2, 3):
        want_p, want_i = jax.lax.top_k(jnp.asarray(gates), k)
        got_p, got_i = moe.top_k(torch.from_numpy(gates), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert moe.top_k(pad, 2)[1].tolist() == [[0, 1]]


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = S - cfg.n_patches if cfg.family == "vlm" else S
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels[..., :3] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["frontend_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_case(request):
    rcfg, cfg = _configs(FAMILIES[request.param])
    params = ref_tfm.init_lm(jax.random.PRNGKey(1), rcfg)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fe = jb.get("frontend_embeds")
    logits, aux = ref_tfm.forward_lm(params, rcfg, jb["tokens"], frontend_embeds=fe)
    loss, grads = jax.value_and_grad(
        lambda p: ref_tfm.lm_loss(p, rcfg, jb["tokens"], jb["labels"],
                                  frontend_embeds=fe)
    )(params)
    model = build_model(cfg)
    module = model.init(device="cpu")
    module.load_state_dict(params_from_jax(_np(params), cfg))
    rtol = 1e-4 if request.param in ("ssm", "hybrid") else 1e-5
    return dict(family=request.param, cfg=cfg, model=model, module=module,
                batch={k: torch.from_numpy(v) for k, v in batch.items()},
                logits=np.asarray(logits), aux=float(aux), loss=float(loss),
                grads=grads, rtol=rtol)


class TestFamilies:
    def test_logits_and_aux(self, family_case):
        c = family_case
        with torch.no_grad():
            logits, aux = c["module"].forward_lm(
                c["batch"]["tokens"],
                frontend_embeds=c["batch"].get("frontend_embeds"))
        assert logits.shape == c["logits"].shape == (B, S, c["cfg"].padded_vocab)
        np.testing.assert_allclose(logits.numpy(), c["logits"], atol=1e-5, rtol=c["rtol"])
        assert float(aux) == pytest.approx(c["aux"], rel=1e-5, abs=1e-7)
        if c["family"] == "moe":
            assert c["aux"] > 0

    def test_loss_and_every_gradient(self, family_case):
        c = family_case
        module, cfg = c["module"], c["cfg"]
        loss = c["model"].loss(module, c["batch"])
        assert float(loss.detach()) == pytest.approx(c["loss"], rel=1e-6)
        names = [n for n, _ in module.named_parameters()]
        grads = torch.autograd.grad(loss, list(module.parameters()))
        want = params_from_jax(_np(c["grads"]), cfg)
        assert sorted(names) == sorted(want)
        for name, g in zip(names, grads):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)

    def test_decay_mask_is_the_reference_rule_on_its_tree(self, family_case):
        """Every leaf of the new families, stacked [L, ...] under
        scan_layers (decayed: the SSM's A_log, D, dt_bias, the hybrid's
        output norms) or not (then 1-D leaves are not)."""
        for scan in (True, False):
            rcfg, cfg = _configs(FAMILIES[family_case["family"]], scan_layers=scan)
            ref = jax.tree.map(lambda a: np.asarray(a).ndim >= 2,
                               ref_tfm.init_lm(jax.random.PRNGKey(0), rcfg))
            if scan:  # one flag per stacked leaf: repeat it per layer
                ref["layers"] = jax.tree.map(
                    lambda f: np.full(cfg.n_layers, f), ref["layers"])
            want = {n: bool(t) for n, t in params_from_jax(_np(ref), cfg).items()}
            assert decay_mask(build_model(cfg).init(device="cpu")) == want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_leaves_stay_f32_in_bf16_models(family):
    """The reference keeps the SSM's A_log, D, dt_bias and the MoE
    router in f32 whatever `param_dtype` says; every other leaf takes it."""
    cfg = dataclasses.replace(get_config(FAMILIES[family]).reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    ref = ref_tfm.init_lm(jax.random.PRNGKey(0), dataclasses.replace(
        ref_config(FAMILIES[family]).reduced(),
        param_dtype="bfloat16", compute_dtype="bfloat16"))
    want = {n: t.dtype for n, t in params_from_jax(_np(ref), cfg).items()}
    module = build_model(cfg).init(device="cpu")
    got = {n: p.dtype for n, p in module.named_parameters()}
    assert got == want
    f32 = {n.split(".")[-1] for n, d in got.items() if d == torch.float32}
    assert f32 == {"ssm": {"A_log", "D", "dt_bias"}, "hybrid": {"A_log", "D", "dt_bias"},
                   "moe": {"router"}, "vlm": set()}[family]
