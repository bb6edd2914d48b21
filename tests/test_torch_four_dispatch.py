"""The PyTorch port's four-dispatch reference route against the reference,
on CPU.

The same windows, made from numpy seeds, go through the JAX package
(Pallas in interpret mode off the TPU; its jnp oracles) and the port
(the frontier, what-if and regime kernels' plain torch versions on CPU
tensors; its torch oracles).  Integer fields must match exactly; float
fields within rtol 1e-5 / atol 1e-6, the tolerance of
`tests/test_torch_fused_tick.py` for the same fields (the port's epilog
sums take another order than XLA's).

Within the port the contract is the reference's own: the four-dispatch
route equals the fused tick bit for bit on every field of every family,
FLT_MIN-fed windows included.  There the reference's own four-dispatch
regime route parts from its fused route (one `sum_excess` cell, by
FLT_MIN); the port follows the fused route, as `TestFltMinDivergence`
shows.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import frontier as jref  # noqa: E402
from repro_torch.kernels import frontier as port  # noqa: E402
from repro_torch.kernels.frontier import frontier as kernels  # noqa: E402
from repro_torch.kernels.frontier import fused  # noqa: E402

_FAMILIES = ("frontier", "whatif", "regimes", "coact")
_TINY = np.finfo(np.float32).tiny


def _window(shape, seed):
    return np.random.default_rng(seed).exponential(1.0, shape).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want, msg):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, msg
    if w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w, err_msg=msg)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=msg)


def _assert_fields_close(got, want, ctx):
    assert got._fields == want._fields, ctx
    for name, g, w in zip(got._fields, got, want):
        _assert_close(g, w, f"{ctx}: {name}")


def _bits(x):
    a = _np(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_tick_bitwise(got, want, ctx):
    """Every family present on both sides, every field bit for bit."""
    for fam in _FAMILIES:
        pg, pw = getattr(got, fam), getattr(want, fam)
        assert (pg is None) == (pw is None), f"{ctx}: {fam} presence"
        if pg is None:
            continue
        for name, g, w in zip(pw._fields, pg, pw):
            assert g.dtype == w.dtype, f"{ctx}: {fam}.{name} dtype"
            np.testing.assert_array_equal(
                _bits(g), _bits(w), err_msg=f"{ctx}: {fam}.{name}"
            )


def _assert_tick_close(got, want, ctx):
    for fam in _FAMILIES:
        pg, pw = getattr(got, fam), getattr(want, fam)
        assert (pg is None) == (pw is None), f"{ctx}: {fam} presence"
        if pg is not None:
            _assert_fields_close(pg, pw, f"{ctx}: {fam}")


# ---------------------------------------------------------------------------
# the kernel routes, their squeezes and loops
# ---------------------------------------------------------------------------

#: (J, N, R, S) and a sync set: the service's six-stage schema, a rank
#: past one tile, one rank, 18 / 33 stages (a barrier past bit 31), and
#: R*S = 910, no multiple of 128, with the last stage synced, over 9 steps
#: and over a single step; one rank at six stages; and (a third element,
#: `_TIED_RANKS`) a window whose max is tied between ranks in different
#: 32-lane groups
_ROUTE_CASES = [
    ((2, 4, 8, 6), (2,)),
    ((2, 3, 129, 5), (1, 4)),
    ((2, 4, 1, 4), (1,)),
    ((2, 3, 6, 18), (2, 5, 8, 11, 14, 17)),
    ((2, 3, 5, 33), tuple(range(2, 33, 3)) + (32,)),
    ((3, 9, 130, 7), (2, 6)),
    ((2, 1, 130, 7), (2, 6)),
    ((3, 5, 1, 6), (2,)),
    ((2, 3, 70, 6), (2,), "tied"),
]
_ROUTE_IDS = ["6st", "r129", "r1", "18st", "33st", "r130s7", "n1", "r1s6",
              "ties"]
#: the ranks that share the window's max in a "tied" case: a frontier
#: kernel's lanes hold whole ranks, so at six stages these fall in three
#: different 32-lane groups
_TIED_RANKS = (5, 37, 69)


def _route_window(case, seed):
    """The window of a `_ROUTE_CASES` entry.  A "tied" case copies one row
    above every rank's (the stagewise max plus 0.5) into `_TIED_RANKS` at
    every (job, step): their stage prefixes tie at the max at every stage,
    so the leader is the lowest of them and the second equals the max."""
    shape = case[0]
    d = _window(shape, seed)
    if case[2:] == ("tied",):
        d[:, :, list(_TIED_RANKS), :] = d.max(axis=2, keepdims=True) + 0.5
    return d


class TestKernelRoutes:
    @pytest.mark.parametrize("case", _ROUTE_CASES, ids=_ROUTE_IDS)
    def test_fleet_frontier_window(self, case):
        shape = case[0]
        d = _route_window(case, seed=sum(shape))
        got = port.fleet_frontier_window(d, device="cpu")
        _assert_fields_close(got, jref.fleet_frontier_window(d), f"{shape}")
        if case[2:] == ("tied",):  # the lowest tied rank leads, gap 0
            assert (got.leader == _TIED_RANKS[0]).all()
            assert (got.gap == 0).all()

    @pytest.mark.parametrize("case", _ROUTE_CASES, ids=_ROUTE_IDS)
    def test_fleet_whatif_matrix(self, case):
        shape, sync = case[:2]
        d = _route_window(case, seed=sum(shape) + 1)
        _assert_fields_close(
            port.fleet_whatif_matrix(d, sync_stages=sync, device="cpu"),
            jref.fleet_whatif_matrix(d, sync_stages=sync), f"{shape}",
        )

    @pytest.mark.parametrize("case", _ROUTE_CASES, ids=_ROUTE_IDS)
    def test_fleet_regime_stats(self, case):
        shape, sync = case[:2]
        d = _route_window(case, seed=sum(shape) + 2)
        got = port.fleet_regime_stats(d, sync_stages=sync, device="cpu")
        want = jref.fleet_regime_stats(d, sync_stages=sync)
        _assert_fields_close(got, want, f"{shape}")

    def test_explicit_baselines(self):
        d = _window((2, 4, 8, 6), seed=31)
        b = _window((8, 6), seed=32) * 0.5                     # [R, S]
        b_jrs = _window((2, 8, 6), seed=33) * 0.5              # [J, R, S]
        _assert_fields_close(
            port.fleet_frontier_window(d, b, device="cpu"),
            jref.fleet_frontier_window(d, b), "frontier",
        )
        _assert_fields_close(
            port.fleet_whatif_matrix(d, b, sync_stages=(2,), device="cpu"),
            jref.fleet_whatif_matrix(d, b, sync_stages=(2,)), "whatif",
        )
        _assert_fields_close(
            port.fleet_regime_stats(d, b_jrs, sync_stages=(2,), device="cpu"),
            jref.fleet_regime_stats(d, b_jrs, sync_stages=(2,)), "regimes",
        )

    def test_single_window_squeezes(self):
        d = _window((4, 8, 6), seed=41)
        _assert_fields_close(
            port.frontier_window(d, device="cpu"), jref.frontier_window(d),
            "frontier_window",
        )
        _assert_fields_close(
            port.frontier_window_reference(d, device="cpu"),
            jref.frontier_window_reference(d), "frontier_window_reference",
        )
        _assert_fields_close(
            port.whatif_matrix(d, sync_stages=(2,), device="cpu"),
            jref.whatif_matrix(d, sync_stages=(2,)), "whatif_matrix",
        )
        _assert_fields_close(
            port.regime_stats_window(d, sync_stages=(2,), device="cpu"),
            jref.regime_stats_window(d, sync_stages=(2,)), "regime_stats_window",
        )

    def test_per_job_loops(self):
        d = _window((2, 4, 8, 6), seed=51)
        _assert_fields_close(
            port.fleet_frontier_loop(d, device="cpu"),
            jref.fleet_frontier_loop(d), "fleet_frontier_loop",
        )
        _assert_fields_close(
            port.regime_stats_loop(d, sync_stages=(2,), device="cpu"),
            jref.regime_stats_loop(d, sync_stages=(2,)), "regime_stats_loop",
        )
        # the batched route equals its per-job loop exactly
        _assert_tick_bitwise(
            fused.FusedTickPacket(
                port.fleet_frontier_window(d, device="cpu"), None,
                port.fleet_regime_stats(d, sync_stages=(2,), device="cpu"), None,
            ),
            fused.FusedTickPacket(
                port.fleet_frontier_loop(d, device="cpu"), None,
                port.regime_stats_loop(d, sync_stages=(2,), device="cpu"), None,
            ),
            "batched vs loop",
        )

    @pytest.mark.parametrize("sync", [None, (1,), (3,)])
    def test_whatif_matrix_loop(self, sync):
        """The O(S*R) replay loop, at a tiny shape: against the JAX loop
        and against the batched matrix (the reference test's 2e-3)."""
        d = _window((3, 4, 4), seed=61)
        loop = port.whatif_matrix_loop(d, sync_stages=sync, device="cpu")
        _assert_close(
            loop, jref.whatif_matrix_loop(jnp.asarray(d), sync_stages=sync), "loop"
        )
        np.testing.assert_allclose(
            loop.numpy(),
            port.whatif_matrix(d, sync_stages=sync, device="cpu").matrix.numpy(),
            atol=2e-3,
        )


# ---------------------------------------------------------------------------
# the reference's contract on the port: four-dispatch == fused, bit for bit
# ---------------------------------------------------------------------------

#: the per-job (N, R, S) groups of `test_torch_fused_tick.py`
_SHAPE_GROUPS = [(2, 3, 6), (4, 8, 3), (1, 1, 4), (3, 16, 8), (3, 129, 5), (2, 300, 6),
                 (9, 130, 7), (1, 130, 7)]


def _both_routes(d, baseline=None, **kw):
    return (
        port.four_dispatch_tick(d, baseline, device="cpu", **kw),
        port.fused_fleet_tick(d, baseline, device="cpu", **kw),
    )


def _accumulation_sync(m, profile):
    """The six-stage contract expanded for accumulation factor m: 3m + 3
    stages, a barrier on the last (or every) microstep's backward."""
    s = 3 * m + 3
    every = tuple(3 * i + 2 for i in range(m))
    return s, (every[-1:] if profile == "last" else every + (s - 1,))


def _tiny_window(shape, seed, base, step):
    """`base` plus 0-59 steps of `step`: excesses, prefixes and sums at or
    around FLT_MIN."""
    k = np.random.default_rng(seed).integers(0, 60, shape).astype(np.float32)
    return (np.float32(base) + k * np.float32(step)).astype(np.float32)


class TestFourDispatchEqualsFused:
    @pytest.mark.parametrize("shape", _SHAPE_GROUPS)
    @pytest.mark.parametrize("jobs", [1, 3])
    def test_shape_groups_with_hosts(self, shape, jobs):
        n, r, s = shape
        d = _window((jobs, n, r, s), seed=n * 100 + r * 10 + s + jobs)
        hosts = np.random.default_rng(jobs).integers(0, 3, (jobs, r))
        four, one = _both_routes(
            d, sync_stages=(1, s - 1), host_index=hosts, num_hosts=3
        )
        _assert_tick_bitwise(four, one, f"{jobs}x{shape}")

    @pytest.mark.parametrize("sync", [None, (2,), (1, 2), (2, 4)])
    def test_service_call(self, sync):
        """The service's call: regimes off, hosts off."""
        d = _window((4, 6, 9, 6), seed=3)
        four, one = _both_routes(d, sync_stages=sync, with_regimes=False)
        _assert_tick_bitwise(four, one, f"sync={sync}")
        assert four.regimes is None and four.coact is None

    @pytest.mark.parametrize("m", [5, 8, 10])
    @pytest.mark.parametrize("profile", ["last", "every"])
    def test_accumulation_schemas(self, m, profile):
        s, sync = _accumulation_sync(m, profile)
        d = _window((2, 5, 12, s), seed=m)
        hosts = np.random.default_rng(m).integers(0, 4, (2, 12))
        four, one = _both_routes(
            d, sync_stages=sync, host_index=hosts, num_hosts=4
        )
        _assert_tick_bitwise(four, one, f"S={s} {profile}")

    @pytest.mark.parametrize("base", [1e-39, 1.2e-38, 2e-38])
    @pytest.mark.parametrize("step", [1e-40, 1e-39])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_flt_min_fed_windows(self, base, step, seed):
        d = _tiny_window((2, 7, 9, 6), seed, base, step)
        hosts = np.random.default_rng(seed).integers(0, 3, (2, 9))
        four, one = _both_routes(
            d, sync_stages=(1, 4), host_index=hosts, num_hosts=3,
            min_excess_s=0.0, rel_excess=0.5,
        )
        _assert_tick_bitwise(four, one, f"base={base} step={step}")

    def test_explicit_baseline(self):
        d = _window((2, 4, 8, 6), seed=11)
        b = _window((8, 6), seed=12)
        hosts = np.random.default_rng(13).integers(0, 4, (2, 8))
        four, one = _both_routes(
            d, b, sync_stages=(2,), host_index=hosts, num_hosts=4
        )
        _assert_tick_bitwise(four, one, "explicit baseline")

    @pytest.mark.parametrize("shape", [(2, 3, 5, 6), (3, 4, 129, 5), (2, 3, 6, 27)])
    def test_composed_oracle_equals_both_routes(self, shape):
        d = _window(shape, seed=sum(shape))
        hosts = np.random.default_rng(7).integers(0, 3, (shape[0], shape[2]))
        kw = dict(sync_stages=(1, shape[3] - 1), host_index=hosts, num_hosts=3)
        ref = port.fused_tick_ref(d, device="cpu", **kw)
        four, one = _both_routes(d, **kw)
        _assert_tick_bitwise(four, ref, f"{shape} four-dispatch vs oracle")
        _assert_tick_bitwise(one, ref, f"{shape} fused vs oracle")


class TestFourDispatchProperty:
    """The JAX package's hypothesis property, on the port: random windows
    (subnormals included), sync sets and host maps."""

    def test_four_dispatch_equals_fused_bitwise(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        shapes = [(1, 3, 2, 3), (2, 4, 5, 4), (3, 2, 9, 5)]

        @st.composite
        def tick_case(draw):
            j, n, r, s = draw(st.sampled_from(shapes))
            flat = draw(st.lists(
                st.floats(min_value=0.0, max_value=50.0, allow_nan=False,
                          allow_infinity=False, width=32),
                min_size=j * n * r * s, max_size=j * n * r * s,
            ))
            d = np.asarray(flat, np.float32).reshape(j, n, r, s)
            sync = tuple(sorted(draw(st.sets(
                st.integers(min_value=0, max_value=s - 1), max_size=s
            ))))
            h = draw(st.integers(min_value=1, max_value=3))
            hosts = np.asarray(draw(st.lists(
                st.integers(min_value=0, max_value=h - 1),
                min_size=j * r, max_size=j * r,
            )), np.int64).reshape(j, r)
            return d, sync, hosts, h

        @settings(max_examples=25, deadline=None, database=None)
        @given(case=tick_case())
        def check(case):
            d, sync, hosts, h = case
            four, one = _both_routes(
                d, sync_stages=sync, host_index=hosts, num_hosts=h
            )
            _assert_tick_bitwise(four, one, f"sync={sync}")

        check()


# ---------------------------------------------------------------------------
# the composed routes against the reference's
# ---------------------------------------------------------------------------


class TestAgainstReference:
    @pytest.mark.parametrize("case", _ROUTE_CASES[:1], ids=_ROUTE_IDS[:1])
    def test_four_dispatch_tick(self, case):
        shape, sync = case
        d = _window(shape, seed=sum(shape) + 5)
        hosts = np.random.default_rng(5).integers(0, 3, (shape[0], shape[2]))
        kw = dict(sync_stages=sync, host_index=hosts, num_hosts=3)
        _assert_tick_close(
            port.four_dispatch_tick(d, device="cpu", **kw),
            jref.four_dispatch_tick(d, **kw), f"{shape}",
        )

    @pytest.mark.parametrize("case", _ROUTE_CASES[:2], ids=_ROUTE_IDS[:2])
    def test_fused_tick_ref(self, case):
        shape, sync = case
        d = _window(shape, seed=sum(shape) + 6)
        hosts = np.random.default_rng(6).integers(0, 4, (shape[0], shape[2]))
        kw = dict(sync_stages=sync, host_index=hosts, num_hosts=4)
        _assert_tick_close(
            port.fused_tick_ref(d, device="cpu", **kw),
            jref.fused_tick_ref(d, **kw), f"{shape}",
        )


# ---------------------------------------------------------------------------
# a schema past the CUDA cell walk's former stage limit; the regime fold's
# "last active step" at its edges
# ---------------------------------------------------------------------------

#: 2,500 stages, past the ~2,400 the CUDA cell walk once staged in shared
#: memory; barriers at 17, past bit 31 (300) and on the last stage
_WIDE_SHAPE, _WIDE_SYNC = (1, 3, 2, 2500), (17, 300, 2499)


@functools.lru_cache(maxsize=1)
def _wide_case():
    """The window, the call's arguments and the reference's composed
    oracle (`fused_tick_ref`, its per-job jnp references: the Pallas
    kernels in interpret mode take minutes at this width)."""
    d = _window(_WIDE_SHAPE, seed=2500)
    kw = dict(sync_stages=_WIDE_SYNC, host_index=np.array([[0, 1]]), num_hosts=2)
    return d, kw, jref.fused_tick_ref(d, **kw)


class TestWideSchema:
    @pytest.mark.parametrize("route", ["fused_fleet_tick", "four_dispatch_tick"])
    def test_plain_route_against_reference(self, route):
        """Every field bit for bit, but the epilog's what-if `exposed`, a
        sum the port takes in another order than XLA's (the module's
        tolerance)."""
        d, kw, want = _wide_case()
        got = getattr(port, route)(d, device="cpu", **kw)
        for fam in _FAMILIES:
            pg, pw = getattr(got, fam), getattr(want, fam)
            for name, g, w in zip(pw._fields, pg, pw):
                ctx = f"{route}: {fam}.{name}"
                if (fam, name) == ("whatif", "exposed"):
                    _assert_close(g, w, ctx)
                else:
                    np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=ctx)


def _activity_window():
    """One job, 5 steps, 4 ranks, 3 stages, 1.0 everywhere but three
    cells 5.0 slower: (stage 0, rank 1) at every step, (stage 1, rank 2)
    at step 0 only, (stage 2, rank 3) at steps 1 and 3.  Every other
    cell's series is empty."""
    d = np.ones((1, 5, 4, 3), np.float32)
    d[0, :, 1, 0] += 5.0
    d[0, 0, 2, 1] += 5.0
    d[0, [1, 3], 3, 2] += 5.0
    return d


class TestRegimeLastStep:
    """The cell walk keeps last = max(last, n) where the reference
    assigns n: the same, since n grows.  Shown on series active at every
    step, at the first step only, at two steps, and empty ones (last -1,
    onset -1 after the epilog), through both routes and the reference."""

    @pytest.mark.parametrize("route", ["fleet_regime_stats", "four_dispatch_tick",
                                       "fused_fleet_tick"])
    def test_last_and_onset(self, route):
        d = _activity_window()
        got = getattr(port, route)(d, device="cpu")
        got = got if route == "fleet_regime_stats" else got.regimes
        want = jref.fleet_regime_stats(d)
        _assert_fields_close(got, want, route)
        last, onset = got.last[0].numpy(), got.onset[0].numpy()   # [S, R]
        expect_last = np.full((3, 4), -1)
        expect_last[0, 1], expect_last[1, 2], expect_last[2, 3] = 4, 0, 3
        np.testing.assert_array_equal(last, expect_last)
        expect_onset = np.full((3, 4), -1)
        expect_onset[0, 1], expect_onset[1, 2], expect_onset[2, 3] = 0, 0, 1
        np.testing.assert_array_equal(onset, expect_onset)
        assert got.count[0, 0, 1] == 5 and got.runs[0, 2, 3] == 2
        assert got.streak[0, 0, 1] == 5 and got.streak[0, 2, 3] == 0


def _flt_min_window():
    """The window the JAX package's hypothesis property fails on: one
    step where eight ranks take 1.0 and one takes FLT_MIN in stage 0,
    zeros elsewhere, so the cohort median of that stage is FLT_MIN / 2."""
    d = np.zeros((3, 2, 9, 5), np.float32)
    d[1, 1, :, 0] = 1.0
    d[1, 1, 7, 0] = _TINY
    return d, dict(sync_stages=(), host_index=np.zeros((3, 9), np.int64),
                   num_hosts=1)


class TestFltMinDivergence:
    """The reference's two routes part on this window: its four-dispatch
    regime route leaves `sum_excess` at 0 in one cell where its fused
    route gives FLT_MIN.  The port's two routes both give the fused
    route's answer."""

    def test_reference_routes_differ_by_flt_min_in_one_cell(self):
        d, kw = _flt_min_window()
        fused_sum = np.asarray(jref.fused_fleet_tick(d, **kw).regimes.sum_excess)
        four_sum = np.asarray(jref.four_dispatch_tick(d, **kw).regimes.sum_excess)
        diff = np.argwhere(fused_sum != four_sum)
        assert diff.tolist() == [[1, 0, 7]]
        assert fused_sum[1, 0, 7] == _TINY and four_sum[1, 0, 7] == 0.0

    def test_port_follows_the_reference_fused_route(self):
        d, kw = _flt_min_window()
        want = jref.fused_fleet_tick(d, **kw)
        four, one = _both_routes(d, **kw)
        _assert_tick_bitwise(four, one, "port routes")
        for name in ("count", "onset", "last", "runs", "streak",
                     "sum_excess", "sum_prefix"):
            np.testing.assert_array_equal(
                _bits(getattr(four.regimes, name)),
                _bits(getattr(want.regimes, name)), err_msg=name,
            )
        assert four.regimes.sum_excess[1, 0, 7].item() == _TINY


# ---------------------------------------------------------------------------
# the kernel boundary
# ---------------------------------------------------------------------------


class TestKernelBoundary:
    def test_cpu_routes_never_launch(self, monkeypatch):
        monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
        monkeypatch.setattr(fused, "launches", 0)
        d = _window((2, 3, 4, 6), seed=1)
        port.four_dispatch_tick(d, device="cpu", sync_stages=(2,))
        port.fleet_regime_stats(d, device="cpu")
        assert set(kernels.launches.values()) == {0}
        assert fused.launches == 0

    @pytest.mark.parametrize("wrapper", ["_frontier_cuda", "_whatif_cuda", "_regime_cuda"])
    def test_kernel_wrappers_refuse_cpu_tensors(self, wrapper):
        x = port.tick_inputs(_window((1, 2, 3, 4), seed=2), device="cpu")
        with pytest.raises(ValueError, match="CUDA tensors"):
            getattr(kernels, wrapper)(x)

    def test_regime_baseline_must_be_constant_over_steps(self):
        d = _window((2, 3, 4, 5), seed=3)
        with pytest.raises(ValueError, match="constant over the steps"):
            port.four_dispatch_tick(d, _window((3, 4, 5), seed=4), device="cpu")
