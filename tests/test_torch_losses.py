"""CPU parity of the port's losses (wealy_tpu_torch.losses) with the JAX
package: the same numpy inputs through clews / ntxent / triplet on both
sides; loss and every logdict key at rtol 1e-5, dL/dz at rtol 1e-4 /
atol 1e-6. Batches include an anchor without a positive, a single-label
batch (the label flip), and the warm-up of CLEWS's uniformity weight."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu import losses as jlosses
from wealy_tpu_torch import losses as tlosses
from wealy_tpu_torch.losses.common import pos_neg_masks, stabilize_labels


def _batch(kind: str, B: int = 8, D: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, D)).astype(np.float32)
    ids = np.arange(B, dtype=np.int32)
    if kind == "pairs":
        labels = np.repeat(np.arange(B // 2), 2).astype(np.int32)
    elif kind == "lonely":  # anchor 0 and anchor B-1 have no positive
        labels = np.concatenate([[100], np.repeat(np.arange((B - 2) // 2), 2), [200]])
        labels = labels.astype(np.int32)
    elif kind == "one_label":  # no negatives: the first labels flip to -1
        labels = np.zeros(B, np.int32)
    else:  # self-repeat: same id twice (p_samesong) is no positive
        labels = np.repeat(np.arange(B // 2), 2).astype(np.int32)
        ids[1] = ids[0]
    return labels, ids, z


def _both(jfn, tfn, labels, ids, z, extra_j=None, extra_t=None):
    """(loss, logdict, dL/dz) of the JAX and the port function."""

    def jloss(zz):
        return jfn(jnp.asarray(labels), jnp.asarray(ids), zz, extra_j)

    (jl, jlog), jdz = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    tl, tlog = tfn(torch.from_numpy(labels), torch.from_numpy(ids), zt, extra_t)
    (tdz,) = torch.autograd.grad(tl, zt)
    return (float(jl), jax.tree_util.tree_map(np.asarray, jlog), np.asarray(jdz),
            float(tl.detach()), {k: v.detach().numpy() for k, v in tlog.items()}, tdz.numpy())


def _assert_same(res):
    jl, jlog, jdz, tl, tlog, tdz = res
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(tlog) == set(jlog)
    for k in jlog:
        np.testing.assert_allclose(tlog[k], jlog[k], rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tdz, jdz, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["pairs", "lonely", "one_label", "self_repeat"])
@pytest.mark.parametrize("name", ["clews", "ntxent", "triplet"])
def test_loss_matches_jax(name, kind):
    labels, ids, z = _batch(kind)
    jfn = {"clews": jlosses.clews_loss, "ntxent": jlosses.ntxent_loss,
           "triplet": jlosses.triplet_loss}[name]
    tfn = {"clews": tlosses.clews_loss, "ntxent": tlosses.ntxent_loss,
           "triplet": tlosses.triplet_loss}[name]
    _assert_same(_both(jfn, tfn, labels, ids, z))


@pytest.mark.parametrize("step", [0, 3, 999, 5000])
def test_clews_uniformity_warmup(step):
    labels, ids, z = _batch("pairs", seed=1)
    res = _both(jlosses.clews_loss, tlosses.clews_loss, labels, ids, z,
                {"global_step": jnp.asarray(step, jnp.int32)}, {"global_step": step})
    _assert_same(res)
    want = 0.5 * min(1.0, (step + 1) / 1000)
    np.testing.assert_allclose(res[4]["uniformity_weight"], want, rtol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("clews", dict(gamma=4.0, b=0.5, uniformity_weight=1.0, warmup_steps=10)),
    ("ntxent", dict(temperature=0.5)),
    ("triplet", dict(margin=0.5, swap=True)),
    ("triplet", dict(p=1.0)),
])
def test_get_loss_with_parameters(name, kwargs):
    labels, ids, z = _batch("lonely", seed=2)
    _assert_same(_both(jlosses.get_loss(name, **kwargs), tlosses.get_loss(name, **kwargs),
                       labels, ids, z, {"global_step": jnp.asarray(4)}, {"global_step": 4}))


def test_clews_numerically_unfriendly_and_sequence_z():
    labels, ids, z = _batch("pairs", seed=3)
    jl, _ = jlosses.CLEWSLoss()(jnp.asarray(labels), jnp.asarray(ids),
                                jnp.asarray(z)[:, None, :], numerically_friendly=False)
    tl, _ = tlosses.CLEWSLoss()(torch.from_numpy(labels), torch.from_numpy(ids),
                                torch.from_numpy(z)[:, None, :], numerically_friendly=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_masks_and_label_flip_match_jax():
    from wealy_tpu.losses.common import pos_neg_masks as jmasks
    from wealy_tpu.losses.common import stabilize_labels as jflip

    for labels in (np.zeros(300, np.int32), np.arange(6, dtype=np.int32) // 2):
        ids = np.arange(len(labels), dtype=np.int32)
        np.testing.assert_array_equal(stabilize_labels(torch.from_numpy(labels)).numpy(),
                                      np.asarray(jflip(jnp.asarray(labels))))
        for a, b in zip(pos_neg_masks(torch.from_numpy(labels), torch.from_numpy(ids)),
                        jmasks(jnp.asarray(labels), jnp.asarray(ids))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unknown_loss_and_small_clews_batch_raise():
    with pytest.raises(KeyError, match="unknown loss"):
        tlosses.get_loss("arcface")
    labels, ids, z = _batch("pairs", B=2)
    with pytest.raises(ValueError, match="B >= 4"):
        tlosses.clews_loss(torch.from_numpy(labels), torch.from_numpy(ids), torch.from_numpy(z))
