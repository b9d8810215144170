"""CPU parity of the port's small numeric ops (wealy_tpu_torch/ops/misc.py)
with the JAX package's, mirroring tests/test_ops_misc.py on the same numpy
arrays (quantiles and flags equal; the covariance rtol 1e-5, the sums run
in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import wealy_tpu_torch.ops as ops
from wealy_tpu.ops import misc as JM
from wealy_tpu_torch.ops import misc as M


def _t(x):
    return torch.from_numpy(np.asarray(x))


class TestQuantile:
    def test_median_odd(self):
        x = np.array([[3.0, 1.0, 2.0, 5.0, 4.0]], np.float32)
        q = np.array([[0.5]], np.float32)
        got = M.tensor_quantile(_t(x), _t(q), axis=-1).numpy()
        np.testing.assert_array_equal(got, np.asarray(JM.tensor_quantile(x, q, axis=-1)))
        np.testing.assert_array_equal(got, [3.0])

    def test_extremes(self):
        x = np.array([[3.0, 1.0, 2.0, 5.0, 4.0]], np.float32)
        for q, want in ((0.0, 1.0), (1.0, 5.0), (-0.5, 1.0), (1.5, 5.0)):
            qa = np.array([[q]], np.float32)
            got = M.tensor_quantile(_t(x), _t(qa)).numpy()
            np.testing.assert_array_equal(got, np.asarray(JM.tensor_quantile(x, qa)))
            np.testing.assert_array_equal(got, [want])

    def test_keepdims(self):
        x = np.random.default_rng(0).random((4, 9)).astype(np.float32)
        q = np.full((4, 1), 0.25, np.float32)
        got = M.tensor_quantile(_t(x), _t(q), axis=-1, keepdims=True)
        assert got.shape == (4, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            JM.tensor_quantile(x, q, axis=-1, keepdims=True)))

    def test_nearest_rank_rounding(self):
        # q=0.5 over 4 elements: rank round(1.5) = 2, half to even as jnp.round
        x = np.array([[10.0, 20.0, 30.0, 40.0]], np.float32)
        q = np.array([[0.5]], np.float32)
        got = M.tensor_quantile(_t(x), _t(q)).numpy()
        np.testing.assert_array_equal(got, np.asarray(JM.tensor_quantile(x, q)))
        np.testing.assert_array_equal(got, [30.0])
        # over 6 elements: round(2.5) = 2 (to even), so sorted[2]
        x6 = np.array([[6.0, 1.0, 5.0, 2.0, 4.0, 3.0]], np.float32)
        np.testing.assert_array_equal(M.tensor_quantile(_t(x6), _t(q)).numpy(), [3.0])
        np.testing.assert_array_equal(np.asarray(JM.tensor_quantile(x6, q)), [3.0])


class TestCovariance:
    def test_decorrelated_near_zero(self, rng):
        x = rng.normal(size=(10000, 4)).astype(np.float32)
        got = float(M.covariance(_t(x)))
        assert got < 1e-2
        np.testing.assert_allclose(got, float(JM.covariance(x)), rtol=1e-4)

    def test_correlated_positive(self, rng):
        a = rng.normal(size=(200, 1)).astype(np.float32)
        x = np.concatenate([a, a, a], axis=1)
        got = float(M.covariance(_t(x)))
        np.testing.assert_allclose(got, a.var(ddof=1) ** 2, rtol=1e-2)
        np.testing.assert_allclose(got, float(JM.covariance(x)), rtol=1e-5)

    def test_hand_computed(self):
        x = np.array([[1.0, 2.0], [3.0, 6.0], [5.0, 10.0]], np.float32)
        xx = x - x.mean(0)
        cov = xx.T @ xx / 2
        want = cov[0, 1] ** 2 / (1 + 1e-6)
        np.testing.assert_allclose(float(M.covariance(_t(x))), want, rtol=1e-5)
        np.testing.assert_allclose(float(M.covariance(_t(x))), float(JM.covariance(x)),
                                   rtol=1e-5)


def test_roughly_equal():
    for a, b in ((1.0, 1.0 + 1e-7), (1.0, 1.1), (0.0, -5e-7), (2.0, 2.000002)):
        got = bool(M.roughly_equal(torch.tensor(a), torch.tensor(b)))
        assert got == bool(JM.roughly_equal(jnp.float32(a), jnp.float32(b)))
    assert bool(M.roughly_equal(torch.tensor(1.0), torch.tensor(1.0 + 1e-7)))
    assert not bool(M.roughly_equal(torch.tensor(1.0), torch.tensor(1.1)))


def test_check_finite():
    for x in (np.ones(3, np.float32), np.array([1.0, np.nan], np.float32),
              np.array([np.inf], np.float32)):
        ok, same = M.check_finite(_t(x))
        assert bool(ok) == bool(JM.check_finite(jnp.asarray(x))[0])
        assert bool(ok) == bool(jax.jit(lambda a: JM.check_finite(a)[0])(x))
        assert same.data_ptr() == _t(x).data_ptr() or torch.equal(same.nan_to_num(), _t(
            x).nan_to_num())


def test_ops_exports_the_tensor_ops_surface():
    """``wealy_tpu_torch.ops`` exports what ``wealy_tpu.ops`` exports."""
    import wealy_tpu.ops as jops

    assert set(jops.__all__) <= set(ops.__all__)
    for name in jops.__all__:
        assert callable(getattr(ops, name)), name
