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


@pytest.mark.parametrize("shape", [(3, 70, 384), (5, 64), (2, 7, 1280), (4, 33), (4, 4096),
                                   (3, 8192)])
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


@pytest.mark.parametrize("shape", [(16, 384), (3, 50, 512), (4, 4096), (2, 8192)])
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
    wide = tln.MAX_D + 1
    for args in ((x, s, s), (x.half(), s, s), (x, s[:32], s),
                 (torch.zeros(2, wide, device="meta"), torch.ones(wide, device="meta"),
                  torch.ones(wide, device="meta"))):
        with pytest.raises(ValueError, match=f"fused_layer_norm.*D <= {tln.MAX_D}"):
            tln.fused_layer_norm(*args)
    assert tln.fused_layer_norm.launches == before


def _plan_columns(plan, D):
    """The columns each access of K6's plan covers, by the kernel's index
    arithmetic (csrc/layer_norm.cu): row route, lane j of a row takes
    accesses j + i * lanes for i < per_lane; block route, thread t takes t,
    t + threads, ...; accesses at or past D / vec hold no column."""
    route, vec, lanes, per_lane = plan
    n = D // vec
    steps = per_lane if route == tln.ROW else -(-n // lanes)
    a = (np.arange(lanes)[:, None] + np.arange(steps)[None, :] * lanes).ravel()
    a = a[a < n]
    return (a[:, None] * vec + np.arange(vec)).ravel()


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_launch_plan_covers_each_column_once(bf16, aligned):
    """For every width from 1 to 8192: K6's plan covers each column exactly
    once; the row route's lanes are a power of 2 up to 32 and a lane holds
    at most ROW_VALUES values, in a register share the kernel is built for,
    split evenly wherever it takes 16-byte accesses; the block route's row
    fits the shared memory of a block; only aligned rows take 16-byte
    accesses."""
    esz = 2 if bf16 else 4
    for D in range(1, 8193):
        route, vec, lanes, per_lane = plan = tln.launch_plan(D, bf16, aligned)
        assert D % vec == 0 and vec in (1, 16 // esz) and (aligned or vec == 1), (D, plan)
        cols = _plan_columns(plan, D)
        assert cols.size == D and np.array_equal(np.sort(cols), np.arange(D)), (D, plan)
        if route == tln.ROW:
            assert lanes in (1, 2, 4, 8, 16, 32) and per_lane in tln.ROW_ACCESSES[vec], (D, plan)
            assert per_lane * vec <= tln.ROW_VALUES, (D, plan)
            assert vec == 1 or lanes * per_lane * vec == D, (D, plan)
        else:
            assert route == tln.BLOCK and lanes == tln.BLOCK_THREADS, (D, plan)
            assert D > 32 * tln.ROW_ACCESSES[1][-1] and D * esz <= 227 * 1024, (D, plan)


def test_launch_plan_splits_the_repo_widths_evenly():
    """The splits the kernel is designed around: 16 lanes x 3 accesses at
    D = 384 bf16 (two rows a warp), 32 x 5 at 1280 bf16, 32 x 3 and 32 x 10
    in f32; one element an access off a 16-byte boundary; the block route
    from 2048 bf16 up to MAX_D."""
    assert tln.launch_plan(384, True, True) == (tln.ROW, 8, 16, 3)
    assert tln.launch_plan(1280, True, True) == (tln.ROW, 8, 32, 5)
    assert tln.launch_plan(512, True, True) == (tln.ROW, 8, 32, 2)
    assert tln.launch_plan(384, False, True) == (tln.ROW, 4, 32, 3)
    assert tln.launch_plan(1280, False, True) == (tln.ROW, 4, 32, 10)
    assert tln.launch_plan(384, True, False) == (tln.ROW, 1, 32, 16)
    assert tln.launch_plan(1280, True, False) == (tln.BLOCK, 1, 256, 5)
    assert tln.launch_plan(100, True, True) == (tln.ROW, 1, 32, 4)
    assert tln.launch_plan(2048, True, True) == (tln.BLOCK, 8, 256, 1)
    assert tln.launch_plan(8192, False, True) == (tln.BLOCK, 4, 256, 8)
    assert tln.launch_plan(tln.MAX_D, False, False) == (tln.BLOCK, 1, 256, 128)


# K6's fused entry (fused_add_layer_norm): the residual add and the LayerNorm
# that reads its sum. On the CPU it is its plain version; the card cases are
# in tests/test_torch_cuda.py (no JAX there).


# 16 rows at every width and dtype; 48,000 rows (the x cells' B=32 x 1500)
# at the narrowest width, within a test worker's host memory (the card cases
# in tests/test_torch_cuda.py take 48,000 rows at every width)
FUSED_CASES = [(dtype, D, 16) for dtype in ("bfloat16", "float32") for D in (384, 1024, 1280, 383)]
FUSED_CASES += [("bfloat16", 384, 48_000)]


@pytest.mark.parametrize("dtype,D,rows", FUSED_CASES)
def test_fused_add_plain_version_matches_jax(dtype, D, rows):
    """(s, h) against the JAX model's ``x + y`` in the compute dtype and its
    LayerNorm of that sum (the Pallas kernel in interpret mode at 16 rows,
    the XLA reference beyond): s equal, h within the JAX tests' bounds."""
    x, scale, bias = _inputs((rows, D), seed=D)
    y = np.random.default_rng(D + 1).normal(size=(rows, D)).astype(np.float32)
    tx, ty = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, y))
    s, h = tln.fused_add_layer_norm(tx, ty, torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert s.dtype == h.dtype == tx.dtype and s.shape == h.shape == (rows, D)
    jx, jy = (jnp.asarray(t.float().numpy()).astype(dtype) for t in (tx, ty))  # the same values
    js = jx + jy
    if rows == 16:
        with pltpu.force_tpu_interpret_mode():
            jh = jln._ln_fwd_impl(js, jnp.asarray(scale), jnp.asarray(bias), EPS)
    else:
        jh = jln._reference_ln(js, jnp.asarray(scale), jnp.asarray(bias), EPS)
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js, np.float32))
    tol = tln.BF16_TOL if dtype == "bfloat16" else tln.F32_TOL
    np.testing.assert_allclose(h.float().numpy(), np.asarray(jh, np.float32), rtol=tol, atol=tol)
    # the plain pair, exactly
    want = tln._reference_ln(tx + ty, torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert torch.equal(s, tx + ty) and torch.equal(h, want)


def test_fused_add_kernel_route_gives_plain_gradients(monkeypatch):
    """The fused entry's autograd Function with its launch routed to the
    plain version on the CPU (returning tensors without a graph, as the
    kernel does): the gradients in x, y, scale and bias of a loss that
    reads both outputs equal autograd of the same pair through ATen's f32
    LayerNorm (what the backward differentiates), and autograd of the
    plain pair within the JAX gradient test's bounds; one launch a call,
    with or without a gradient."""
    x, scale, bias = _inputs((6, 48), seed=7)
    y = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    rng = np.random.default_rng(9)
    rs, rh = (torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)) for _ in range(2))

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, y, scale, bias)]
        s, h = fn(*leaves)
        ((s * rs).sum() + (h * rh).sum()).backward()
        return (s.detach(), h.detach()), [leaf.grad for leaf in leaves]

    def plain(x, y, scale, bias):
        return x + y, tln._reference_ln(x + y, scale, bias, EPS)

    want_out, want = grads(plain)
    _, aten = grads(lambda *a: tln._aten_add_ln(*a, EPS))
    calls = []

    def launch(x, y, scale, bias, eps):
        calls.append(x.shape)
        return tuple(t.detach() for t in tln._reference_add_ln(x, y, scale, bias, eps))

    monkeypatch.setattr(tln, "_kernel_route", lambda t: True)
    monkeypatch.setattr(tln, "_launch_add_ln", launch)
    got_out, got = grads(lambda *a: tln.fused_add_layer_norm(*a, EPS))
    assert calls == [(6, 48)]
    for g, w in zip(got_out, want_out):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, a, w in zip(got, aten, want):
        torch.testing.assert_close(g, a, rtol=0, atol=0)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    # the gradient of an output the loss does not read is zero, not missing
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, y, scale, bias)]
    tln.fused_add_layer_norm(*leaves, EPS)[1].sum().backward()
    assert all(leaf.grad is not None for leaf in leaves)
    with torch.no_grad():
        tln.fused_add_layer_norm(*(torch.from_numpy(a) for a in (x, y, scale, bias)))
    assert len(calls) == 3


def test_fused_add_refuses_what_the_kernel_does_not_take():
    """On a device other than the CPU the fused entry launches K6 or raises:
    x outside bf16 and f32, y of another shape, dtype or device, weights of
    another width or dtype, rows wider than MAX_D; nothing launches."""
    before = tln.fused_layer_norm.launches
    x = torch.zeros(4, 64, device="meta")
    s = torch.ones(64, device="meta")
    wide = tln.MAX_D + 1
    for args in ((x.half(), x.half(), s, s), (x, x[:, :32], s, s), (x, x.bfloat16(), s, s),
                 (x, torch.zeros(4, 64), s, s), (x, x, s[:32], s), (x, x, s.bfloat16(), s),
                 (torch.zeros(2, wide, device="meta"), torch.zeros(2, wide, device="meta"),
                  torch.ones(wide, device="meta"), torch.ones(wide, device="meta"))):
        with pytest.raises(ValueError, match=f"fused_add_layer_norm.*D <= {tln.MAX_D}"):
            tln.fused_add_layer_norm(*args)
    assert tln.fused_layer_norm.launches == before


def test_k6_takes_bf16_and_f32_card_rows():
    """The route the Whisper blocks choose from the input alone: the CPU
    and other devices take the plain version; on a card (its device faked
    here) the dtype and the width decide."""
    assert not tln.takes(torch.zeros(2, 64)) and not tln.takes(torch.zeros(2, 64, device="meta"))

    class Card:
        device = torch.device("cuda")

        def __init__(self, dtype, D):
            self.dtype, self.shape = dtype, (3, D)

        def dim(self):
            return 2

    assert tln.takes(Card(torch.bfloat16, 1280)) and tln.takes(Card(torch.float32, 384))
    assert not tln.takes(Card(torch.float16, 1280))
    assert not tln.takes(Card(torch.bfloat16, tln.MAX_D + 1))
