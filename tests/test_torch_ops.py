"""Port of the encoder kernels' functions (wealy_tpu_torch.ops) against the
JAX package: flash_mha (K2) and fused_mlp (K3) on the same seeded inputs.
On the CPU the wrappers run their plain versions, as the JAX functions do;
tests/test_torch_cuda.py holds each kernel against its plain version on the
card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.ops.flash_attention import flash_mha as jflash_mha
from wealy_tpu.ops.fused_mlp import fused_mlp as jfused_mlp
from wealy_tpu_torch.ops import BF16_COS_MIN as COS_MIN
from wealy_tpu_torch.ops import BF16_REL_ABS as REL_ABS
from wealy_tpu_torch.ops.flash_attention import flash_mha
from wealy_tpu_torch.ops.fused_mlp import fused_mlp

from _torch_parity import min_row_cosine, to_numpy


def _qkv(rng, B, T, H, Dh=64, Tk=None):
    Tk = Tk or T
    return [
        rng.normal(size=(B, t, H, Dh)).astype(np.float32) for t in (T, Tk, Tk)
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_matches_jax(dtype):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 300, 3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jflash_mha(*(jnp.asarray(a, jd) for a in (q, k, v)), 0.125), np.float32)
    got = to_numpy(flash_mha(*(torch.from_numpy(a).to(td) for a in (q, k, v)), 0.125))
    assert got.shape == want.shape == (2, 300, 3, 64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert min_row_cosine(got, want) >= COS_MIN
        assert np.abs(got - want).max() <= REL_ABS * np.abs(want).max()


def test_flash_mha_cross_lengths():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 17, 2, Tk=45)
    want = np.asarray(jflash_mha(*(jnp.asarray(a) for a in (q, k, v)), 0.125))
    got = flash_mha(*(torch.from_numpy(a) for a in (q, k, v)), 0.125).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _mlp_inputs(rng, N, D):
    x = rng.normal(size=(N, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, 4 * D)) * D**-0.5).astype(np.float32)  # JAX (in, out)
    b1 = (0.1 * rng.normal(size=4 * D)).astype(np.float32)
    w2 = (rng.normal(size=(4 * D, D)) * (4 * D) ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.normal(size=D)).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("D", [64, 384])
@pytest.mark.parametrize("N", [1, 517])
def test_fused_mlp_matches_jax(N, D):
    rng = np.random.default_rng(2)
    x, w1, b1, w2, b2 = _mlp_inputs(rng, N, D)
    bf = jnp.bfloat16
    want = np.asarray(
        jfused_mlp(jnp.asarray(x, bf), jnp.asarray(w1, bf), jnp.asarray(b1),
                   jnp.asarray(w2, bf), jnp.asarray(b2)),
        np.float32,
    )
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = to_numpy(
        fused_mlp(t(x).bfloat16(), t(w1.T).bfloat16(), t(b1), t(w2.T).bfloat16(), t(b2))
    )
    assert got.shape == want.shape == (N, D)
    assert min_row_cosine(got, want) >= COS_MIN
    assert np.abs(got - want).max() <= REL_ABS * np.abs(want).max()


def test_fused_mlp_keeps_leading_axes():
    rng = np.random.default_rng(3)
    x, w1, b1, w2, b2 = _mlp_inputs(rng, 6, 64)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = (t(w1.T).bfloat16(), t(b1), t(w2.T).bfloat16(), t(b2))
    flat = fused_mlp(t(x).bfloat16(), *args)
    got = fused_mlp(t(x).bfloat16().reshape(2, 3, 64), *args)
    assert got.shape == (2, 3, 64)
    assert torch.equal(got.reshape(6, 64), flat)
