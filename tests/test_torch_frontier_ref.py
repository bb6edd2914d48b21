"""The PyTorch port's plain-torch oracles against the reference's, on CPU.

`repro_torch.kernels.frontier.ref` (torch) and `repro.kernels.frontier.ref`
(jnp) take the same windows and baselines, made from numpy seeds, at one
rank, a rank past a 128-rank tile and 5 to 33 stages (past the 16-stage
block of the prefix), under sync sets from none to every stage.  Integer
fields must match exactly; float fields within rtol 1e-5 / atol 1e-6, the
tolerance of `tests/test_torch_fused_tick.py` (the what-if oracle sums
its steps in order, the reference's in XLA's order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import frontier as jref  # noqa: E402
from repro_torch.kernels import frontier as port  # noqa: E402


def _window(shape, seed):
    return np.random.default_rng(seed).exponential(1.0, shape).astype(np.float32)


def _assert_close(got, want, msg):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, msg
    if w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w, err_msg=msg)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=msg)


def _assert_fields_close(got, want, ctx):
    assert got._fields == want._fields, ctx
    for name, g, w in zip(got._fields, got, want):
        _assert_close(g, w, f"{ctx}: {name}")


def _imputed(d, sync):
    if not sync:
        return d
    w = d.copy()
    w[..., list(sync)] = d.min(axis=-2, keepdims=True)[..., list(sync)]
    return w


def _median(x):
    """Midpoint cohort median per stage of one window x[N, R, S]."""
    n, r, s = x.shape
    return np.median(x.reshape(n * r, s), axis=0).astype(np.float32)


#: (N, R, S): one rank, a rank past a 128-rank tile, and the
#: accumulation-expanded stage counts past the 16-stage prefix block
_ORACLE_SHAPES = [(4, 1, 5), (3, 129, 5), (4, 7, 18), (3, 6, 27), (3, 5, 33)]
_SYNC_SETS = ["none", "2", "1,2", "2,4", "all"]


def _sync(name, s):
    if name == "all":
        return tuple(range(s))
    return () if name == "none" else tuple(int(i) for i in name.split(","))


class TestOracles:
    @pytest.mark.parametrize("shape", _ORACLE_SHAPES)
    @pytest.mark.parametrize("explicit", [False, True])
    def test_frontier_window_ref(self, shape, explicit):
        d = _window(shape, seed=sum(shape))
        b = (_window(shape[1:], seed=1) if explicit
             else np.ascontiguousarray(np.broadcast_to(_median(d), shape)))
        got = port.frontier_window_ref(d, b)
        want = jref.frontier_window_ref(d, b)
        _assert_fields_close(got, want, f"{shape}")

    @pytest.mark.parametrize("shape", _ORACLE_SHAPES)
    @pytest.mark.parametrize("sync", _SYNC_SETS)
    def test_whatif_matrix_ref(self, shape, sync):
        d = _window(shape, seed=sum(shape) + 1)
        syncs = _sync(sync, shape[2])
        b = _median(_imputed(d, syncs))
        _assert_close(
            port.whatif_matrix_ref(d, b, syncs),
            jref.whatif_matrix_ref(d, b, syncs),
            f"{shape} sync={sync}",
        )

    @pytest.mark.parametrize("shape", _ORACLE_SHAPES)
    @pytest.mark.parametrize("sync", _SYNC_SETS)
    def test_regime_segments_ref(self, shape, sync):
        d = _window(shape, seed=sum(shape) + 2)
        syncs = _sync(sync, shape[2])
        b = _median(_imputed(d, syncs))
        kw = dict(sync_stages=syncs, min_excess_s=0.05, rel_excess=0.3)
        got = port.regime_segments_ref(d, b, **kw)
        want = jref.regime_segments_ref(d, b, **kw)
        _assert_fields_close(got, want, f"{shape} sync={sync}")
        if sync != "all":   # every rank then carries the step's minimum
            assert int(got.count.sum()) > 0, "the oracle saw no activity"
