"""K6's plain version and module (wealy_tpu_torch.ops.layer_norm,
models/layers.py::LayerNormFused) against the JAX package's fused LayerNorm
on the CPU: the JAX side runs its Pallas kernel in interpret mode
(``_ln_fwd_impl``) and its XLA reference; tolerances are those of
tests/test_layer_norm.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wealy_tpu.models.layers import LayerNormFused as JLayerNormFused
from wealy_tpu.ops import layer_norm as jln
from wealy_tpu_torch.models.convert import layer_norm_state_dict_from_jax_params
from wealy_tpu_torch.models.layers import LayerNormFused
from wealy_tpu_torch.ops import layer_norm as tln

EPS = 1e-5


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 2 + 0.5
    scale = rng.normal(size=shape[-1:]).astype(np.float32) + 1.0
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(3, 70, 384), (5, 64), (2, 7, 1280), (4, 33)])
def test_plain_version_matches_jax_f32(shape):
    x, scale, bias = _inputs(shape)
    got = tln._reference_ln(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
                            EPS).numpy()
    want_ref = np.asarray(jln._reference_ln(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                            EPS))
    with pltpu.force_tpu_interpret_mode():
        want_kernel = np.asarray(jln._ln_fwd_impl(jnp.asarray(x), jnp.asarray(scale),
                                                  jnp.asarray(bias), EPS))
    tol = tln.F32_TOL
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(16, 384), (3, 50, 512)])
def test_plain_version_matches_jax_bf16(shape):
    x, scale, bias = _inputs(shape, seed=1)
    xb = torch.from_numpy(x).bfloat16()
    got = tln._reference_ln(xb, torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert got.dtype == torch.bfloat16
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)  # the same bf16 values
    with pltpu.force_tpu_interpret_mode():
        want = jln._ln_fwd_impl(xj, jnp.asarray(scale), jnp.asarray(bias), EPS)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tln.BF16_TOL, atol=tln.BF16_TOL)


def test_gradients_match_jax():
    x, scale, bias = _inputs((4, 32), seed=2)
    r = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)  # a fixed readout

    def jloss(x, s, b):
        return jnp.sum(jln.fused_layer_norm(x, s, b, EPS) * r)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    (tln.fused_layer_norm(*leaves, EPS) * torch.from_numpy(r)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_module_carries_jax_params():
    x, _, _ = _inputs((2, 10, 16), seed=3)
    jmod = JLayerNormFused()
    params = jmod.init(jax.random.PRNGKey(0), x)["params"]
    assert set(params) == {"scale", "bias"}
    params = {"scale": np.asarray(params["scale"]) * 1.5, "bias": np.asarray(params["bias"]) + 0.1}
    want = np.asarray(jmod.apply({"params": params}, x))
    mod = LayerNormFused(16)
    assert set(dict(mod.named_parameters())) == {"scale", "bias"}
    assert mod.scale.dtype == mod.bias.dtype == torch.float32
    assert torch.equal(mod.scale.detach(), torch.ones(16)) and not mod.bias.detach().any()
    mod.load_state_dict(layer_norm_state_dict_from_jax_params(params))
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="scale and bias"):
        layer_norm_state_dict_from_jax_params({"weight": params["scale"]})


def test_kernel_route_gives_plain_gradients(monkeypatch):
    """The autograd Function with its launch routed to the plain version on
    the CPU (returning a tensor without a graph, as the kernel does) gives
    the plain gradients in x, scale and bias, and launches once per call."""
    x, scale, bias = _inputs((6, 48), seed=4)
    r = torch.from_numpy(np.random.default_rng(6).normal(size=x.shape).astype(np.float32))

    def grads():
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
        out = tln.fused_layer_norm(*leaves, EPS)
        (out * r).sum().backward()
        return out.detach(), [leaf.grad for leaf in leaves]

    want_out, want = grads()
    calls = []

    def launch(x, scale, bias, eps):
        calls.append(x.shape)
        return tln._reference_ln(x, scale, bias, eps).detach()

    monkeypatch.setattr(tln, "_kernel_route", lambda t: True)
    monkeypatch.setattr(tln, "_launch_ln", launch)
    got_out, got = grads()
    assert calls == [(6, 48)]
    torch.testing.assert_close(got_out, want_out, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    # without a gradient the forward alone runs, through the same launch
    with torch.no_grad():
        tln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias))
    assert len(calls) == 2


def test_wrapper_refuses_what_the_kernel_does_not_take():
    before = tln.fused_layer_norm.launches
    x = torch.zeros(4, 64, device="meta")
    s = torch.ones(64, device="meta")
    for args in ((x, s, s), (x.half(), s, s), (x, s[:32], s),
                 (torch.zeros(2, 4096, device="meta"), torch.ones(4096, device="meta"),
                  torch.ones(4096, device="meta"))):
        with pytest.raises(ValueError, match="fused_layer_norm"):
            tln.fused_layer_norm(*args)
    assert tln.fused_layer_norm.launches == before
