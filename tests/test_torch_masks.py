"""CPU parity of the port's mask converters (wealy_tpu_torch/utils/masks.py)
with the JAX package's, mirroring the mask part of
tests/test_utils_masks_registry.py on the same numpy arrays (equal)."""

import numpy as np
import pytest
import torch

from wealy_tpu.utils.masks import excluded_to_valid as j_e2v
from wealy_tpu.utils.masks import valid_to_excluded as j_v2e
from wealy_tpu_torch.utils.masks import excluded_to_valid, valid_to_excluded


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_mask_converters_roundtrip(rng):
    m = rng.random((4, 5)) > 0.5
    np.testing.assert_array_equal(valid_to_excluded(_t(m)).numpy(), np.asarray(j_v2e(m)))
    np.testing.assert_array_equal(excluded_to_valid(_t(m)).numpy(), np.asarray(j_e2v(m)))
    np.testing.assert_array_equal(valid_to_excluded(_t(m)).numpy(), ~m)
    np.testing.assert_array_equal(excluded_to_valid(valid_to_excluded(_t(m))).numpy(), m)
    # numpy input too, as the JAX converters take it
    np.testing.assert_array_equal(valid_to_excluded(m).numpy(), ~m)


@pytest.mark.parametrize("shape", [(7,), (2, 3, 4), (0, 5)])
def test_mask_converters_keep_shape_and_dtype(rng, shape):
    m = rng.random(shape) > 0.5
    for port, jax_fn in ((valid_to_excluded, j_v2e), (excluded_to_valid, j_e2v)):
        got = port(_t(m))
        assert got.dtype == torch.bool and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fn(m)))
