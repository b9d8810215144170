"""CPU parity of the port's reduction ops (wealy_tpu_torch.ops: masked,
distance, redux, bpwr_redux) against the JAX package on the same numpy
inputs. Tolerances: rtol/atol 1e-6 on the same distance tensor (f32 sums in
another order), 1e-5 for distance matrices (products of 8 to 40 terms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.ops import distance as jdist
from wealy_tpu.ops import masked as jmasked
from wealy_tpu.ops.pallas_redux import bpwr_block_redux as jax_bpwr_block_redux
from wealy_tpu.ops.redux import distance_tensor_redux as jax_redux
from wealy_tpu_torch.ops import distance as tdist
from wealy_tpu_torch.ops import masked as tmasked
from wealy_tpu_torch.ops.bpwr_redux import _reference_bpwr_block, bpwr_block_redux
from wealy_tpu_torch.ops.redux import distance_tensor_redux, ordered_selected_mean

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _case(seed, shape=(3, 4, 5, 6), p=0.3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, size=shape).astype(np.float32)
    mask = rng.uniform(size=shape) < p
    return x, mask


@pytest.mark.parametrize("op", ["msum", "mmean", "mmin", "mmax"])
@pytest.mark.parametrize("axis", [None, -1, (1, 2), (-1, -2)])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_reductions(op, axis, keepdims, masked):
    x, mask = _case(0)
    m = mask if masked else None
    want = getattr(jmasked, op)(jnp.asarray(x), None if m is None else jnp.asarray(m),
                                axis=axis, keepdims=keepdims)
    got = getattr(tmasked, op)(_t(x), None if m is None else _t(m), axis=axis, keepdims=keepdims)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("op", ["mbest", "mworst"])
@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_topk_means(op, k, masked):
    x, mask = _case(1)
    m = mask if masked else None
    want = getattr(jmasked, op)(jnp.asarray(x), k, None if m is None else jnp.asarray(m), axis=-1)
    got = getattr(tmasked, op)(_t(x), k, None if m is None else _t(m), axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mrand_picks_the_only_valid_entry():
    """With one unmasked entry per group, mrand is that entry on both sides
    (the two frameworks draw different noise from a seed)."""
    x, _ = _case(2, shape=(4, 5, 6))
    mask = np.ones_like(x, bool)
    rng = np.random.default_rng(3)
    keep = rng.integers(0, 6, size=(4, 5))
    np.put_along_axis(mask, keep[..., None], False, axis=-1)
    want = jmasked.mrand(jnp.asarray(x), jax.random.PRNGKey(0), jnp.asarray(mask), axis=-1)
    got = tmasked.mrand(_t(x), torch.Generator().manual_seed(0), _t(mask), axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # unmasked: the pick is one of the row's entries
    got = tmasked.mrand(_t(x), torch.Generator().manual_seed(1), axis=-1).numpy()
    assert np.all(np.isclose(x, got[..., None], rtol=0, atol=0).any(axis=-1))


@pytest.mark.parametrize(
    "mode", ["fro", "nfro", "euc", "neuc", "sqeuc", "nsqeuc", "cos", "cossim", "dot", "dotsim"]
)
@pytest.mark.parametrize("p", [2, 1.5])
def test_pairwise_distance_modes(mode, p):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(7, 40)).astype(np.float32)
    y = rng.normal(size=(9, 40)).astype(np.float32)
    want = jdist.pairwise_distance_matrix(jnp.asarray(x), jnp.asarray(y), mode=mode, p=p)
    got = tdist.pairwise_distance_matrix(_t(x), _t(y), mode=mode, p=p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pairwise_distance_1d():
    rng = np.random.default_rng(5)
    x, y = rng.normal(size=8).astype(np.float32), rng.normal(size=5).astype(np.float32)
    want = jdist.pairwise_distance_matrix(jnp.asarray(x), jnp.asarray(y), mode="euc")
    got = tdist.pairwise_distance_matrix(_t(x), _t(y), mode="euc")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


REDUX_MODES = ["min", "max", "mean", "minmean", "meanmin", "bpwr", "bpwr-2", "best", "best-3",
               "worst", "worst-4", "bestmin", "bestmin-2", "smin", "smean", "sbpwr", "sbpwr-3",
               "sbest-2", "smeanmin", "sbestmin-2"]


@pytest.mark.parametrize("redux", REDUX_MODES)
@pytest.mark.parametrize("shape", [(3, 4, 5, 6), (2, 3, 6, 4), (2, 2, 1, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_distance_tensor_redux_modes(redux, shape, masked):
    d, mask = _case(6, shape)
    mask[:, :, 0, 0] = False  # every pair keeps a valid entry
    m = mask if masked else None
    want = jax_redux(jnp.asarray(d), redux, mask=None if m is None else jnp.asarray(m))
    got = distance_tensor_redux(_t(d), redux, mask=None if m is None else _t(m))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_randomised_modes():
    """randmin without a generator raises on both sides; jittered bpwr (noise
    of eps = 1e-7) stays within 1e-6 of the JAX jittered result."""
    d, mask = _case(7, (3, 4, 6, 6))
    mask[:, :, 0, 0] = False
    with pytest.raises(ValueError):
        distance_tensor_redux(_t(d), "randmin")
    want = jax_redux(jnp.asarray(d), "bpwr", mask=jnp.asarray(mask), key=jax.random.PRNGKey(0))
    got = distance_tensor_redux(_t(d), "bpwr", mask=_t(mask),
                                generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # randmin: a single valid entry per pair makes the pick deterministic
    one = np.ones_like(mask)
    one[:, :, 3, 2] = False
    want = jax_redux(jnp.asarray(d), "randmin", mask=jnp.asarray(one), key=jax.random.PRNGKey(1))
    got = distance_tensor_redux(_t(d), "randmin", mask=_t(one),
                                generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unknown_redux_raises():
    with pytest.raises(NotImplementedError):
        distance_tensor_redux(torch.zeros(1, 1, 2, 2), "median")


def test_ordered_selected_mean_order():
    """The plain mean adds each row left to right, then the rows top to
    bottom: K4's order, so the kernel can be bit-equal to it."""
    rng = np.random.default_rng(8)
    d = rng.uniform(0, 2, size=(2, 3, 4, 5)).astype(np.float32)
    sel = rng.uniform(size=d.shape) < 0.5
    got = ordered_selected_mean(_t(d), _t(sel), 1e-7)[..., 0, 0].numpy()
    for a in range(2):
        for b in range(3):
            total = np.float32(0)
            for i in range(4):
                row = np.float32(0)
                for j in range(5):
                    row = np.float32(row + (d[a, b, i, j] if sel[a, b, i, j] else np.float32(0)))
                total = np.float32(total + row)
            want = np.float32(total / max(np.float32(sel[a, b].sum()), np.float32(1e-7)))
            assert got[a, b] == want


# --- bpwr_block_redux: the cases of tests/test_pallas_redux.py -------------


def _rand_case(rng, Q, B, s1, s2, mask_p=0.3):
    d = rng.uniform(0.0, 2.0, size=(Q, B, s1, s2)).astype(np.float32)
    qvalid = rng.uniform(size=(Q, s1)) > mask_p
    cvalid = rng.uniform(size=(B, s2)) > mask_p
    qvalid[:, 0] = True
    cvalid[:, 0] = True
    return d, qvalid, cvalid


def _both(d, qv, cv, redux="bpwr"):
    want = jax_bpwr_block_redux(jnp.asarray(d), jnp.asarray(qv), jnp.asarray(cv), redux,
                                interpret=True)
    got = bpwr_block_redux(_t(d), _t(qv), _t(cv), redux)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("shape", [(5, 7, 4, 6), (3, 9, 6, 4), (2, 3, 1, 5), (4, 2, 5, 1),
                                   (1, 1, 3, 3)])
@pytest.mark.parametrize("redux", ["bpwr", "bpwr-2"])
def test_bpwr_block_matches_jax_kernel(shape, redux):
    rng = np.random.default_rng(sum(shape) + len(redux))
    got, want = _both(*_rand_case(rng, *shape), redux)
    assert got.shape == shape[:2]
    np.testing.assert_allclose(got, want, **TOL)


def test_bpwr_block_fully_masked_pairs_are_zero():
    rng = np.random.default_rng(0)
    d, qv, cv = _rand_case(rng, 4, 6, 3, 5, mask_p=0.0)
    cv[4:] = False
    qv[1] = False
    got, want = _both(d, qv, cv)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[:, 4:] == 0.0) and np.all(got[1] == 0.0)


def test_bpwr_block_tied_minima():
    rng = np.random.default_rng(1)
    d, qv, cv = _rand_case(rng, 3, 4, 4, 5, mask_p=0.0)
    d[:, :, 2, 3] = d[:, :, 1, 0]  # exact cross-row/col tie
    d[0, 0] = 0.5  # a tile of one value: every entry ties every round
    got, want = _both(d, qv, cv)
    np.testing.assert_allclose(got, want, **TOL)


def test_bpwr_block_lane_padding_shape():
    rng = np.random.default_rng(2)
    got, want = _both(*_rand_case(rng, 2, 2, 3, 3))
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_bpwr_block_70x70_tile():
    """The tile the JAX kernel leaves to XLA (above its VMEM budget); the
    port's kernel takes it (its block route)."""
    rng = np.random.default_rng(3)
    got, want = _both(*_rand_case(rng, 2, 2, 70, 70))
    np.testing.assert_allclose(got, want, **TOL)


def test_bpwr_block_reads_a_strided_view():
    """The rank passes hand the kernel the (Q, N, s1, s2) view of the
    (Q*s1, N*s2) distance matrix; the plain path gives the same values for
    the view and for a contiguous copy."""
    rng = np.random.default_rng(9)
    flat = rng.uniform(0, 2, size=(3 * 4, 5 * 6)).astype(np.float32)
    view = _t(flat).reshape(3, 4, 5, 6).permute(0, 2, 1, 3)
    qv = _t(rng.uniform(size=(3, 4)) > 0.2)
    cv = _t(rng.uniform(size=(5, 6)) > 0.2)
    a = bpwr_block_redux(view, qv, cv)
    b = bpwr_block_redux(view.contiguous(), qv, cv)
    assert torch.equal(a, b)


def test_bpwr_block_rejects_other_modes():
    with pytest.raises(ValueError, match="bpwr"):
        bpwr_block_redux(torch.zeros(1, 1, 2, 2), torch.ones(1, 2, dtype=torch.bool),
                         torch.ones(1, 2, dtype=torch.bool), "smean")


# --- K4's sorted-route knockout, modelled in plain torch --------------------


def _lane_model(d, qv, cv, redux, eps=1e-7, inf=1e12):
    """K4's sorted route as plain torch: rows (the smaller side) are lanes,
    column liveness is one bitmask per pair and row liveness one flag per
    lane; each round every lane takes its row's live minimum, the minimum
    across the lanes gives mn, each lane sets the bits of its live entries
    <= mn, the OR of the lanes' bits knocks the columns out, and a lane with
    a bit knocks its own row out. A lane selects in at most one round, so its
    selection is one mask, and the mean adds in the kernel's order."""
    Q, B, s1, s2 = d.shape
    n_req = s1 if "-" not in redux else int(redux.split("-")[-1])
    swap = s2 < s1
    rows = d.transpose(2, 3) if swap else d  # (Q, B, R, C)
    R, C = rows.shape[2:]
    if swap:
        rlive, cmask = cv[None].expand(Q, B, R).clone(), qv[:, None].expand(Q, B, C)
    else:
        rlive, cmask = qv[:, None].expand(Q, B, R).clone(), cv[None].expand(Q, B, C)
    bit = 2 ** torch.arange(C, dtype=torch.int64)
    ccol = (cmask.long() * bit).sum(-1)  # (Q, B): the live columns as bits
    selected = torch.zeros(Q, B, R, dtype=torch.int64)  # each lane's selection mask
    for _ in range(max(1, min(n_req, R))):
        col_live = (ccol[..., None, None] & bit) != 0
        vals = torch.where(rlive[..., None] & col_live, rows, torch.tensor(float("inf")))
        m = torch.clamp(vals.amin(-1), max=inf)  # each lane's row minimum, inf when dead
        mn = m.amin(-1, keepdim=True)  # the minimum across the lanes
        hit = (vals <= mn[..., None]) & (mn < inf)[..., None]
        lane_bits = (hit.long() * bit).sum(-1)  # (Q, B, R)
        assert not bool(((lane_bits != 0) & (selected != 0)).any()), "a row selected twice"
        dead = torch.zeros_like(ccol)
        for r in range(R):  # the OR across the lanes
            dead = dead | lane_bits[..., r]
        selected = torch.where(lane_bits != 0, lane_bits, selected)
        rlive = rlive & (lane_bits == 0)
        ccol = ccol & ~dead
    sel = (selected[..., None] & bit) != 0
    return ordered_selected_mean(rows, sel, eps)[..., 0, 0]


def _model_case(name):
    rng = np.random.default_rng(len(name))
    if name == "ties":
        d, qv, cv = _rand_case(rng, 3, 4, 5, 6, mask_p=0.0)
        d = np.round(d * 2) / 2  # values on a grid of 0.5: ties in rows and columns
        d[0, 0] = 0.5  # a tile of one value: every entry ties in the first round
        return d.astype(np.float32), qv, cv, "bpwr"
    if name == "fully masked":
        d, qv, cv = _rand_case(rng, 4, 6, 3, 5)
        cv[4:] = False
        qv[1] = False
        return d, qv, cv, "bpwr"
    if name == "s1 > s2":
        return (*_rand_case(rng, 3, 5, 9, 4), "bpwr")
    if name == "wide":
        return (*_rand_case(rng, 2, 3, 12, 40), "bpwr")
    return (*_rand_case(rng, 3, 4, 6, 7), name)  # bpwr-1, bpwr-50


@pytest.mark.parametrize("name", ["ties", "fully masked", "bpwr-1", "bpwr-50", "s1 > s2",
                                  "wide"])
def test_lane_knockout_model(name):
    """The sorted route's formulation, bit-equal to the plain ``_bpwr`` and
    within TOL of the JAX kernel (interpret mode)."""
    d, qv, cv, redux = _model_case(name)
    got = _lane_model(_t(d), _t(qv), _t(cv), redux)
    plain = _reference_bpwr_block(_t(d), _t(qv), _t(cv), redux, 1e-7, 1e12)
    assert torch.equal(got, plain)
    _, want = _both(d, qv, cv, redux)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
