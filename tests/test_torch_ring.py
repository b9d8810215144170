"""Ring attention of the port (wealy_tpu_torch/parallel/ring.py) on 2 and 4
gloo CPU ranks, held against the JAX package's ring on the virtual devices
and its plain softmax attention (tests/test_ring.py): the same output
(max error 1e-5) with a ring of every rank, with a key mask (a rank whose
whole block is padding included), composed with data parallelism, its
gradients with respect to q, k and v (1e-5), bf16 inputs within 0.05 of
the f32 reference, and the ``ValueError`` of a sequence that does not
divide the ring. One spawn per world size runs every case
(tests/_torch_ring_cases.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.parallel.ring import make_cp_mesh as j_cp_mesh
from wealy_tpu.parallel.ring import ring_attention as j_ring
from wealy_tpu_torch.parallel.mesh import Mesh
from wealy_tpu_torch.parallel.ring import ring_attention

from _torch_parity import spawn_ranks


def _reference(q, k, v, scale, kv_mask=None):
    s = jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32), k.astype(jnp.float32)) * scale
    if kv_mask is not None:
        s = jnp.where(kv_mask[:, None, None, :], s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v.astype(jnp.float32)).astype(q.dtype)


def _qkv(rng, b=2, t=48, h=3, d=8):
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    n = request.param
    devs = jax.devices()
    plain = _qkv(np.random.default_rng(0))
    scale = float(1.0 / np.sqrt(8))
    mask_qkv = _qkv(np.random.default_rng(1), t=32)
    mask = np.ones((2, 32), bool)
    mask[0, 10:] = False  # the later blocks of row 0 are all padding
    mask[1, 29:] = False
    dp_qkv = _qkv(np.random.default_rng(2), b=4, t=24)
    rng = np.random.default_rng(3)
    grad_qkv = _qkv(rng, b=1, t=16, h=2, d=4)
    w = rng.normal(size=(1, 16, 2, 4)).astype(np.float32)
    ref = {
        "plain": np.asarray(j_ring(*plain, scale, j_cp_mesh(n, devices=devs[:n]))),
        "plain_ref": np.asarray(_reference(*plain, scale)),
        "mask": np.asarray(j_ring(*mask_qkv, 0.25, j_cp_mesh(n, devices=devs[:n]),
                                  kv_mask=jnp.asarray(mask))),
        "mask_ref": np.asarray(_reference(*mask_qkv, 0.25, jnp.asarray(mask))),
        "bf16_ref": np.asarray(_reference(*mask_qkv, 0.25)),
        "dp": np.asarray(j_ring(*dp_qkv, 0.3, j_cp_mesh(2, n_data=2, devices=devs[:4]))),
        "grads": jax.grad(lambda q, k, v: jnp.sum(_reference(q, k, v, 0.5) * w),
                          argnums=(0, 1, 2))(*grad_qkv),
    }
    work = tmp_path_factory.mktemp(f"ring{n}")
    t = torch.from_numpy
    torch.save({"plain": tuple(map(t, plain)), "plain_scale": scale,
                "mask_qkv": tuple(map(t, mask_qkv)), "mask": t(mask),
                "dp_qkv": tuple(map(t, dp_qkv)), "grad_qkv": tuple(map(t, grad_qkv)),
                "grad_w": t(w)}, work / "inputs.pt")
    return ref, spawn_ranks("_torch_ring_cases", n, work)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def test_ring_matches_single_device(ranks):
    ref, results = ranks
    for res in results:
        assert _err(res["plain"], ref["plain"]) < 1e-5
        assert _err(res["plain"], ref["plain_ref"]) < 1e-5


def test_ring_with_padding_mask(ranks):
    ref, results = ranks
    for res in results:
        np.testing.assert_allclose(res["mask"].numpy(), ref["mask"], atol=1e-5)
        np.testing.assert_allclose(res["mask"].numpy(), ref["mask_ref"], atol=1e-5)


def test_ring_composes_with_dp(ranks):
    ref, results = ranks
    for res in results:
        if res["world"] == 4:  # (data 2, cp 2)
            np.testing.assert_allclose(res["dp"].numpy(), ref["dp"], atol=1e-5)


def test_ring_is_trainable(ranks):
    ref, results = ranks
    for res in results:
        for name, a, b in zip("qkv", res["grads"], ref["grads"]):
            err = _err(a, b)
            assert err < 1e-5, f"d{name}: max_err={err}"


def test_ring_bf16_inputs(ranks):
    ref, results = ranks
    for res in results:
        np.testing.assert_allclose(res["bf16"].numpy(), ref["bf16_ref"], rtol=0.05, atol=0.05)


def test_ring_rejects_indivisible_seq():
    mesh = Mesh(4, 0, torch.device("cpu"), False, ("data", "cp"), (1, 4))
    q = torch.zeros((1, 30, 2, 4))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(q, q, q, 0.5, mesh)
