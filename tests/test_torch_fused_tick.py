"""The PyTorch port's fused fleet tick against the JAX reference, on CPU.

The same windows, made from numpy seeds, go through
`repro.kernels.frontier.fused_fleet_tick` (Pallas in interpret mode off
the TPU) and `repro_torch.kernels.frontier.fused_fleet_tick` (its plain
torch version on CPU tensors).  Integer fields must match exactly; float
fields within rtol 1e-5 / atol 1e-6, because the port's epilog sums
(shares, gains, exposed) take another order than XLA's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.frontier import fused_fleet_tick as jax_tick  # noqa: E402
from repro_torch.kernels.frontier import fused, ops  # noqa: E402
from repro_torch.kernels.frontier import fused_fleet_tick as torch_tick  # noqa: E402

# the per-job (N, R, S) groups of tests/test_fused_tick.py, plus a rank
# count past one 128-rank tile and one past two, and the CUDA kernel's
# thread-mapping tails: R*S = 910, no multiple of 128 (the last stage is
# synced, see `test_all_families`), over 9 steps and over a single step
_SHAPE_GROUPS = [(2, 3, 6), (4, 8, 3), (1, 1, 4), (3, 16, 8), (3, 129, 5), (2, 300, 6),
                 (9, 130, 7), (1, 130, 7)]

#: stage-index sync profiles of the simulator's six-stage schema
_SYNCS = {"none": None, "ddp": (2,), "fsdp": (1, 2)}

_FAMILIES = ("frontier", "whatif", "regimes", "coact")


def _window(shape, seed):
    return np.random.default_rng(seed).exponential(1.0, shape).astype(np.float32)


def _assert_tick_close(got, want, *, context=""):
    """Every family present on both sides; ints exact, floats close."""
    for fam in _FAMILIES:
        pg, pw = getattr(got, fam), getattr(want, fam)
        assert (pg is None) == (pw is None), f"{context}: {fam} presence"
        if pg is None:
            continue
        assert pg._fields == pw._fields, f"{context}: {fam} fields"
        for field in pw._fields:
            g = getattr(pg, field).numpy()
            w = np.asarray(getattr(pw, field))
            msg = f"{context}: {fam}.{field}"
            assert g.shape == w.shape, msg
            if w.dtype.kind in "iub":
                np.testing.assert_array_equal(g, w, err_msg=msg)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=msg)


def _both(d, baseline=None, **kw):
    return (
        torch_tick(d, baseline, device="cpu", **kw),
        jax_tick(d, baseline, **kw),
    )


class TestShapeGroups:
    @pytest.mark.parametrize("shape", _SHAPE_GROUPS)
    @pytest.mark.parametrize("jobs", [1, 3])
    def test_all_families(self, shape, jobs):
        n, r, s = shape
        d = _window((jobs, n, r, s), seed=n * 100 + r * 10 + s + jobs)
        hosts = np.random.default_rng(jobs).integers(0, 3, (jobs, r))
        kw = dict(sync_stages=(1, s - 1), host_index=hosts, num_hosts=3)
        got, want = _both(d, **kw)
        _assert_tick_close(got, want, context=f"{jobs}x{shape}")

    @pytest.mark.parametrize("sync", sorted(_SYNCS))
    @pytest.mark.parametrize("with_regimes", [True, False])
    def test_sync_profiles(self, sync, with_regimes):
        d = _window((3, 5, 16, 6), seed=len(sync) + 10 * with_regimes)
        got, want = _both(
            d, sync_stages=_SYNCS[sync], with_regimes=with_regimes
        )
        _assert_tick_close(got, want, context=f"{sync} regimes={with_regimes}")
        assert got.coact is None

    def test_hosts_without_regimes(self):
        d = _window((3, 6, 10, 6), seed=5)
        hosts = np.random.default_rng(6).integers(0, 4, (3, 10))
        got, want = _both(
            d, sync_stages=(2,), host_index=hosts, num_hosts=4,
            with_regimes=False,
        )
        _assert_tick_close(got, want, context="hosts only")
        assert got.regimes is None and got.coact is not None

    @pytest.mark.parametrize("sync", sorted(_SYNCS))
    def test_service_call(self, sync):
        """The service's call: regimes off, hosts off."""
        d = _window((4, 6, 9, 6), seed=3)
        got, want = _both(d, sync_stages=_SYNCS[sync], with_regimes=False)
        _assert_tick_close(got, want, context=sync)
        assert got.regimes is None and got.coact is None

    def test_explicit_baseline(self):
        d = _window((2, 4, 8, 6), seed=11)
        b = np.random.default_rng(12).exponential(1.0, (8, 6)).astype(np.float32)
        hosts = np.random.default_rng(13).integers(0, 4, (2, 8))
        got, want = _both(
            d, b, sync_stages=(2,), host_index=hosts, num_hosts=4
        )
        _assert_tick_close(got, want, context="explicit baseline")

    def test_quiet_window_has_no_activity(self):
        d = np.full((2, 3, 4, 5), 0.5, np.float32)
        hosts = np.zeros((2, 4), np.int64)
        got, want = _both(d, sync_stages=(2,), host_index=hosts, num_hosts=2)
        _assert_tick_close(got, want, context="quiet")
        assert int(got.regimes.count.sum()) == 0
        assert int(got.coact.active.sum()) == 0


class TestMedian:
    def test_even_sample_count_takes_the_midpoint(self):
        """N*R even: the baseline is the mean of the two middle samples,
        as `jnp.median` computes it; `torch.median` would return the lower
        one and shift every clipped gain."""
        d = _window((2, 2, 3, 4), seed=21)       # N*R = 6 samples
        x = torch.from_numpy(d)
        med = ops.fleet_median_baseline(x)
        v = np.sort(d.reshape(2, 6, 4), axis=1)
        np.testing.assert_array_equal(med.numpy(), (v[:, 2] + v[:, 3]) * 0.5)
        lower = torch.median(x.reshape(2, 6, 4), dim=1).values
        assert not torch.equal(med, lower)
        got, want = _both(d, sync_stages=(1,))
        _assert_tick_close(got, want, context="even N*R")


class TestKernelBoundary:
    def test_cpu_path_never_launches(self):
        before = fused.launches
        torch_tick(_window((2, 3, 4, 5), seed=1), device="cpu")
        assert fused.launches == before

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        x = fused.tick_inputs(_window((1, 2, 3, 4), seed=2), device="cpu")
        with pytest.raises(ValueError, match="CUDA tensors"):
            fused._fused_tick_cuda(x)

    def test_bad_arguments_raise(self):
        d = _window((2, 3, 4, 5), seed=3)
        with pytest.raises(ValueError, match="num_hosts"):
            torch_tick(d, host_index=np.zeros((2, 4)), device="cpu")
        with pytest.raises(ValueError, match="host_index"):
            torch_tick(d, host_index=np.zeros((2, 5)), num_hosts=2, device="cpu")
        with pytest.raises(ValueError, match="sync stage"):
            torch_tick(d, sync_stages=(5,), device="cpu")


def _accumulation_stages(m):
    """The six-stage contract expanded for accumulation factor m: 3m + 3
    stages; returns (S, the last microstep's backward, every backward)."""
    from repro_torch.core.accumulation import expand_schema
    from repro_torch.core.contract import segmented_schema

    stages = expand_schema(segmented_schema(8), m).stages
    bwd = tuple(i for i, s in enumerate(stages) if s.startswith("model.backward"))
    return len(stages), bwd[-1:], bwd


class TestManyStages:
    """Accumulation-expanded schemas (3m + 3 stages) run past the 16 stages
    the kernel's register variants hold; 33 stages also put a barrier past
    bit 31 of a 32-bit mask."""

    @pytest.mark.parametrize("m", [5, 8, 10])
    @pytest.mark.parametrize("profile", ["last_backward", "every_backward"])
    def test_accumulation_schema(self, m, profile):
        s, last, every = _accumulation_stages(m)
        assert s == 3 * m + 3
        sync = last if profile == "last_backward" else every + (s - 1,)
        d = _window((2, 5, 12, s), seed=m)
        hosts = np.random.default_rng(m).integers(0, 4, (2, 12))
        got, want = _both(d, sync_stages=sync, host_index=hosts, num_hosts=4)
        _assert_tick_close(got, want, context=f"m={m} S={s} {profile}")

    @pytest.mark.parametrize("s", [1, 6, 16, 17, 33, 256, 257, 300, 600])
    def test_stage_prefix_takes_the_reference_order(self, s):
        """Past 16 stages XLA's cumulative sum adds in blocks of 16 (and
        blocks of blocks past 256): the port's prefix is bit-equal."""
        import jax.numpy as jnp

        x = _window((3, 4, s), seed=s)
        got = ops.stage_prefix(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(x, axis=-1)))

    def test_service_call_at_33_stages(self):
        s, _, every = _accumulation_stages(10)
        d = _window((3, 4, 9, s), seed=33)
        got, want = _both(d, sync_stages=every + (32,), with_regimes=False)
        _assert_tick_close(got, want, context="S=33 service call")


def _tiny_window(shape, seed, base, step):
    """Windows at the bottom of the float32 range: `base` plus 0-59 steps
    of `step`, so excesses, prefixes and sums land at or around FLT_MIN."""
    k = np.random.default_rng(seed).integers(0, 60, shape).astype(np.float32)
    return (np.float32(base) + k * np.float32(step)).astype(np.float32)


class TestSubnormals:
    """Values below FLT_MIN flush to zero as in the reference (XLA's CPU
    runtime flushes them): every float field equals JAX bit for bit, apart
    from `shares` and `gains`, whose vectorised sum over the steps takes
    another order than XLA's.  Those two hold the module's tolerance and
    differ by at most 2 ulp on these inputs."""

    _ORDERED_SUMS = {("frontier", "shares"), ("frontier", "gains")}

    @pytest.mark.parametrize("base", [1e-39, 1.2e-38, 2e-38])
    @pytest.mark.parametrize("step", [1e-40, 1e-39])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_bitwise_against_reference(self, base, step, seed):
        d = _tiny_window((2, 7, 9, 6), seed, base, step)
        hosts = np.random.default_rng(seed).integers(0, 3, (2, 9))
        kw = dict(sync_stages=(1, 4), host_index=hosts, num_hosts=3,
                  min_excess_s=0.0, rel_excess=0.5)
        got, want = _both(d, **kw)
        for fam in _FAMILIES:
            pg, pw = getattr(got, fam), getattr(want, fam)
            for field in pw._fields:
                g = getattr(pg, field).numpy()
                w = np.asarray(getattr(pw, field))
                msg = f"{fam}.{field} base={base} seed={seed}"
                if w.dtype.kind != "f":
                    np.testing.assert_array_equal(g, w, err_msg=msg)
                elif (fam, field) in self._ORDERED_SUMS:
                    np.testing.assert_allclose(
                        g, w, rtol=1e-5, atol=1e-6, err_msg=msg
                    )
                    np.testing.assert_array_max_ulp(g, w, maxulp=2)
                else:
                    np.testing.assert_array_equal(
                        g.view(np.int32), w.view(np.int32), err_msg=msg
                    )

    def test_flush_reaches_the_regime_sums(self):
        """The case found against the reference: sums that JAX returns as
        0.0 or FLT_MIN are never left as subnormals."""
        d = _tiny_window((2, 7, 9, 6), 0, 2e-38, 1e-39)
        got = torch_tick(d, device="cpu", sync_stages=(1, 4),
                         min_excess_s=0.0, rel_excess=0.0)
        tiny = np.finfo(np.float32).tiny
        for fam in ("frontier", "whatif", "regimes"):
            for field, t in zip(getattr(got, fam)._fields, getattr(got, fam)):
                if t.dtype.is_floating_point:
                    v = np.abs(t.numpy())
                    assert not ((v > 0) & (v < tiny)).any(), f"{fam}.{field}"
        assert (got.regimes.sum_prefix.numpy() > 0).any()
        assert (got.whatif.matrix.numpy() > 0).any()

    def test_ftz_helper(self):
        tiny = np.finfo(np.float32).tiny
        x = torch.tensor([tiny, tiny / 2, -tiny / 4, 0.0, -0.0, 1.0,
                          float("inf"), float("nan")])
        y = ops.ftz(x).numpy()
        assert y[0] == tiny and y[5] == 1.0 and np.isinf(y[6]) and np.isnan(y[7])
        assert y[1] == 0.0 and not np.signbit(y[1])
        assert y[2] == 0.0 and np.signbit(y[2])
        assert np.signbit(y[4])
