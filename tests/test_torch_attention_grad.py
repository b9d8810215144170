"""Gradients of the port's encoder kernels on the CPU.

- The attention backward (``flash_mha`` as a ``torch.autograd.Function``)
  against the JAX package's Pallas backward ``_flash_mha_bwd_impl`` run in
  TPU interpret mode, as tests/test_flash_attention.py runs it:
  (1, 200, 2, 64) and (2, 300, 2, 64), rtol/atol 2e-3, and rows whose
  softmax is nearly one-hot (q and k scaled up).
- The delta K5a writes and K5b reads: rowsum(p * dp) in f32, the TPU
  kernels' form.
- ``fused_mlp``'s backward against the JAX ``custom_vjp``.
- The gradient wiring of the kernel route: with the kernel launches replaced
  by their plain versions, an encoder's q/k/v projections and MLP weights
  get the plain gradients. Before ``flash_mha`` and ``fused_mlp`` became
  autograd Functions, the kernel route returned tensors without a graph and
  those gradients were silently missing on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wealy_tpu.ops.flash_attention import _flash_mha_bwd_impl
from wealy_tpu.ops.fused_mlp import fused_mlp as jfused_mlp
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.model import WhisperEncoder
from wealy_tpu_torch.ops import flash_attention as fa
from wealy_tpu_torch.ops import fused_mlp as fm


def _qkvg(shape, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=shape).astype(np.float32) * 0.4 for _ in range(2))
    v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("shape", [(1, 200, 2, 64), (2, 300, 2, 64)])
def test_attention_backward_matches_jax_pallas_interpret(shape):
    q, k, v, g = _qkvg(shape, seed=shape[1])
    scale = 64**-0.5
    with pltpu.force_tpu_interpret_mode():
        want = _flash_mha_bwd_impl(*(jnp.asarray(a) for a in (q, k, v, g)), scale, 128)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_mha(*leaves, scale)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for t, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3,
                                   err_msg=name)


def test_attention_backward_one_hot_rows_match_jax_pallas_interpret():
    """Rows whose softmax is nearly one-hot (q and k scaled up 3.7x, scaled
    scores to about +-50), where dp - delta cancels: the port's backward
    against the Pallas backward in TPU interpret mode, rtol/atol 2e-3 (both
    f32; the JAX kernels sum delta = rowsum(p * dp) as the port does)."""
    rng = np.random.default_rng(61)
    q, k = (rng.normal(size=(1, 200, 2, 64)).astype(np.float32) * 3.7 for _ in range(2))
    v, g = (rng.normal(size=(1, 200, 2, 64)).astype(np.float32) for _ in range(2))
    scale = 64**-0.5
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", torch.from_numpy(q),
                                   torch.from_numpy(k)) * scale, dim=-1)
    assert (p.amax(-1) > 0.99).float().mean() > 0.3  # a third of the rows nearly one-hot
    with pltpu.force_tpu_interpret_mode():
        want = _flash_mha_bwd_impl(*(jnp.asarray(a) for a in (q, k, v, g)), scale, 128)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    fa.flash_mha(*leaves, scale).backward(torch.from_numpy(g))
    for t, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3,
                                   err_msg=name)


def test_backward_wrappers_and_delta_identity():
    """flash_mha_bwd_dq / _dkv on CPU tensors: the plain gradients, and the
    delta K5a writes equals rowsum(p * dp) of the TPU kernel's form."""
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg((2, 37, 3, 64), seed=5))
    scale = 0.125
    _, lse = fa.flash_mha_fwd(q, k, v, scale, with_lse=True)
    assert lse is None  # the plain backward needs none
    dq, delta = fa.flash_mha_bwd_dq(q, k, v, g, lse, scale)
    dk, dv = fa.flash_mha_bwd_dkv(q, k, v, g, lse, delta, scale)
    ref = fa._reference_mha_grads(q, k, v, g, scale)
    for a, b in zip((dq, dk, dv), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    torch.testing.assert_close(delta, (p * dp).sum(-1), rtol=1e-5, atol=1e-5)


def test_no_grad_forward_saves_nothing():
    q = torch.randn(1, 8, 2, 64)
    with torch.no_grad():
        assert fa.flash_mha(q.requires_grad_(True), q, q, 0.125).grad_fn is None
    x = torch.randn(2, 3, 64)
    w1, w2 = torch.randn(256, 64), torch.randn(64, 256)
    assert fm.fused_mlp(x, w1, torch.zeros(256), w2, torch.zeros(64)).grad_fn is None


def test_fused_mlp_backward_matches_jax():
    rng = np.random.default_rng(3)
    D, Dff = 64, 256
    x = rng.normal(size=(2, 5, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, Dff)) * D**-0.5).astype(np.float32)  # JAX layout (in, out)
    w2 = (rng.normal(size=(Dff, D)) * Dff**-0.5).astype(np.float32)
    b1 = (0.1 * rng.normal(size=Dff)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=D)).astype(np.float32)
    g = rng.normal(size=(2, 5, D)).astype(np.float32)
    _, vjp = jax.vjp(jfused_mlp, *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
              for a in (x, w1.T, b1, w2.T, b2)]
    fm.fused_mlp(*leaves).backward(torch.from_numpy(g))
    got = [leaves[0].grad, leaves[1].grad.T, leaves[2].grad, leaves[3].grad.T, leaves[4].grad]
    for a, b, name in zip(got, want, ("x", "w1", "b1", "w2", "b2")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)


def _plain_launches(monkeypatch):
    """Route every wrapper to its kernel branch, with each launch replaced
    by its plain version (returning tensors without a graph, as a kernel
    does). Returns the call counts."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0, "mlp": 0}

    def fwd(q, k, v, scale, with_lse):
        calls["fwd"] += 1
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        lse = torch.logsumexp(s, dim=-1) if with_lse else None
        return fa._reference_mha(q, k, v, scale).detach(), lse

    def dq(q, k, v, g, lse, scale):
        calls["dq"] += 1
        delta = fa._reference_delta(q, k, v, g, scale)
        return fa._reference_mha_grads(q, k, v, g, scale, wrt=(0,))[0], delta

    def dkv(q, k, v, g, lse, delta, scale):
        calls["dkv"] += 1
        return fa._reference_mha_grads(q, k, v, g, scale, wrt=(1, 2))

    def mlp(x, w1, b1, w2, b2):
        calls["mlp"] += 1
        return fm._reference_mlp(x, w1, b1, w2, b2).detach()

    monkeypatch.setattr(fa, "_kernel_route", lambda t: True)
    monkeypatch.setattr(fa, "_launch_fwd", fwd)
    monkeypatch.setattr(fa, "_launch_dq", dq)
    monkeypatch.setattr(fa, "_launch_dkv", dkv)
    monkeypatch.setattr(fm, "_kernel_route", lambda t: True)
    monkeypatch.setattr(fm, "_launch_mlp", mlp)
    return calls


def _encoder_grads(enc, mel, readout):
    """Gradients of a fixed random readout of the encoder states (the
    states are LayerNorm'd, so mean(out ** 2) would be nearly constant)."""
    enc.zero_grad()
    (enc(mel).float() * readout).mean().backward()
    return {n: p.grad.float().clone() for n, p in enc.named_parameters()
            if p.grad is not None}


def test_kernel_route_wires_gradients(monkeypatch):
    """A two-block bf16 encoder (T = 256, so attention and MLP take the
    kernel route): every q/k/v/out projection and MLP weight gets the plain
    path's gradient through the kernel route."""
    cfg = WhisperConfig(n_mels=8, n_audio_ctx=256, n_audio_state=128, n_audio_head=2,
                        n_audio_layer=2, n_vocab=64, n_text_ctx=8, n_text_state=128,
                        n_text_head=2, n_text_layer=1)
    torch.manual_seed(0)
    enc = WhisperEncoder(cfg, dtype=torch.bfloat16)
    for name, p in enc.named_parameters():
        if p.dim() > 1:
            torch.nn.init.normal_(p, std=p[0].numel() ** -0.5)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.normal(size=(1, 8, 512)).astype(np.float32))
    readout = torch.from_numpy(rng.normal(size=(1, 256, 128)).astype(np.float32))
    want = _encoder_grads(enc, mel, readout)
    calls = _plain_launches(monkeypatch)
    got = _encoder_grads(enc, mel, readout)
    assert calls == {"fwd": 2, "dq": 2, "dkv": 2, "mlp": 2}
    assert set(got) == set(want)
    for i in range(2):
        for leaf in ("attn.query.weight", "attn.key.weight", "attn.value.weight",
                     "attn.out.weight", "mlp.0.weight", "mlp.0.bias", "mlp.2.weight"):
            name = f"blocks.{i}.{leaf}"
            assert got[name].abs().max() > 0, name
            torch.testing.assert_close(got[name], want[name], rtol=1e-6, atol=0, msg=name)
