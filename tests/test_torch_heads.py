"""CPU parity of the port's heads (wealy_tpu_torch.models: layers, heads,
registry, convert) against the flax modules, with the flax init carried
across by ``head_state_dict_from_jax_params``. f32 on both sides: atol 1e-4
and a per-row cosine >= 0.99999 (convolutions summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.models.heads import ProjectionHead as JProjectionHead
from wealy_tpu.models.heads import SequenceProjectionHead as JSequenceProjectionHead
from wealy_tpu.models.layers import ConvBlock as JConvBlock
from wealy_tpu.models.layers import mean_pool as jmean_pool
from wealy_tpu.models.registry import MODEL_NAMES as JMODEL_NAMES
from wealy_tpu.models.registry import build_model as jbuild_model
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params
from wealy_tpu_torch.models.heads import ProjectionHead, SequenceProjectionHead, seeded_init_
from wealy_tpu_torch.models.layers import ConvBlock, MeanPool, mean_pool
from wealy_tpu_torch.models.registry import MODEL_NAMES, build_model

from _torch_parity import min_row_cosine


def _inputs(B=3, T=17, C=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 11:] = False
    mask[2, 5:] = False
    return x, mask


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert min_row_cosine(got, want) >= 0.99999


def _init(jmodule, *args):
    params = jmodule.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("kernel_size,stride", [(3, 1), (3, 2), (5, 3), (1, 1)])
def test_conv_block(kernel_size, stride):
    x, _ = _inputs()
    jm = JConvBlock(20, kernel_size=kernel_size, stride=stride)
    params = _init(jm, x)
    want = jm.apply({"params": params}, jnp.asarray(x))
    port = ConvBlock(24, 20, kernel_size=kernel_size, stride=stride)
    port.load_state_dict(head_state_dict_from_jax_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_mean_pool(masked):
    x, mask = _inputs()
    m = mask if masked else None
    want = jmean_pool(jnp.asarray(x), None if m is None else jnp.asarray(m))
    got = MeanPool()(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    _close(got, want)
    assert torch.equal(got, mean_pool(torch.from_numpy(x), None if m is None else torch.from_numpy(m)))


@pytest.mark.parametrize("strides", [None, (2, 1), (1, 3)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("l2", [False, True])
def test_projection_head(strides, masked, l2):
    x, mask = _inputs()
    jm = JProjectionHead(zdim=16, hidden=(20, 12), strides=strides, l2_normalize=l2)
    params = _init(jm, x, mask)
    m = mask if masked else None
    want = jm.apply({"params": params}, jnp.asarray(x), None if m is None else jnp.asarray(m))
    port = ProjectionHead(24, zdim=16, hidden=(20, 12), strides=strides, l2_normalize=l2).eval()
    port.load_state_dict(head_state_dict_from_jax_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    _close(got, want)


@pytest.mark.parametrize("strides", [None, (2,)])
def test_sequence_projection_head(strides):
    x, mask = _inputs()
    jm = JSequenceProjectionHead(zdim=8, hidden=(10,), strides=strides)
    params = _init(jm, x, mask)
    want, wmask = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    port = SequenceProjectionHead(24, zdim=8, hidden=(10,), strides=strides).eval()
    port.load_state_dict(head_state_dict_from_jax_params(params))
    with torch.no_grad():
        got, gmask = port(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got.reshape(-1, 8), np.asarray(want).reshape(-1, 8))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


def test_converter_layouts():
    """Conv (k, Cin, Cout) -> (Cout, Cin, k); Dense (in, out) -> (out, in);
    LayerNorm scale -> weight."""
    params = {
        "conv_0": {"conv": {"kernel": np.zeros((3, 5, 7))},
                   "norm": {"scale": np.ones(7), "bias": np.zeros(7)}},
        "proj": {"kernel": np.zeros((7, 4)), "bias": np.zeros(4)},
    }
    sd = head_state_dict_from_jax_params(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "conv_0.conv.weight": (7, 5, 3), "conv_0.norm.weight": (7,), "conv_0.norm.bias": (7,),
        "proj.weight": (4, 7), "proj.bias": (4,),
    }
    with pytest.raises(ValueError):
        head_state_dict_from_jax_params({"x": {"embedding": np.zeros(2)}})


def test_registry():
    assert MODEL_NAMES == JMODEL_NAMES
    model, sig = build_model("whisper", zdim=32, in_features=24)
    assert sig == "single" and isinstance(model, ProjectionHead)
    assert model.proj.out_features == 32 and model.conv_0.conv.in_channels == 24
    # the fusion names build, with the JAX registry's signatures
    # (tests/test_torch_fusion.py holds their outputs against JAX)
    for name in MODEL_NAMES[1:]:
        fused, fsig = build_model(name, zdim=32, in_features=24, wealy_features=16,
                                  clews_features=12)
        assert fsig == jbuild_model(name)[1] and isinstance(fused, torch.nn.Module)
    with pytest.raises(KeyError):
        build_model("nope")


def test_seeded_init_is_reproducible():
    a = seeded_init_(ProjectionHead(24, zdim=16, hidden=(20, 12)), seed=0)
    b = seeded_init_(ProjectionHead(24, zdim=16, hidden=(20, 12)), seed=0)
    c = seeded_init_(ProjectionHead(24, zdim=16, hidden=(20, 12)), seed=1)
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith("conv.weight"):
            assert not torch.equal(pa, pc)
            assert abs(pa.std().item() - pa[0].numel() ** -0.5) < 0.3 * pa[0].numel() ** -0.5
    assert torch.equal(a.conv_0.norm.weight, torch.ones(20))
    assert torch.equal(a.proj.bias, torch.zeros(16))
