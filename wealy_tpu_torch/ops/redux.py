"""Segment-pair distance reduction: the counterpart of
``wealy_tpu.ops.redux``. Reduces a (b1, b2, s1, s2) tensor of segment-pair
distances to (b1, b2) song-pair distances; ``mask`` True = excluded.

``_bpwr`` is the plain version of kernel K4 (``ops/bpwr_redux.py``). Its
rounds are a Python loop of whole-tensor ops, and its final mean adds the
selected entries in a fixed order (each row left to right, then the row sums
top to bottom) so that K4, which adds in the same order, gives bit-equal
results. The JAX package sums in XLA's order; the two agree to f32 rounding.
"""

from __future__ import annotations

from typing import Optional

import torch

from wealy_tpu_torch.ops.masked import mbest, mmax, mmean, mmin, mrand, mworst


def ordered_selected_mean(dist, sel, eps: float):
    """sum(dist[sel]) / max(count, eps) over the last two dims, keepdims.

    The sum runs along each row from column 0, then over the row sums from
    row 0, each add one float32 rounding, which is the order K4 uses.
    """
    v = torch.where(sel, dist, torch.zeros((), dtype=dist.dtype, device=dist.device))
    rows = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for j in range(v.shape[-1]):
        rows = rows + v[..., j]
    total = torch.zeros(v.shape[:-2], dtype=v.dtype, device=v.device)
    for i in range(v.shape[-2]):
        total = total + rows[..., i]
    count = sel.sum(dim=(-1, -2), dtype=v.dtype)
    return (total / count.clamp(min=eps))[..., None, None]


def _bpwr(dist, mask, n: int, eps: float, inf: float, generator: Optional[torch.Generator]):
    """Greedy best pairs without replacement over the last two dims: each of
    ``n`` rounds selects the live entries at the global live minimum and
    knocks out every row and column whose live minimum reaches it."""
    if dist.shape[3] < dist.shape[2]:  # transpose so that s1 <= s2
        dist = dist.transpose(2, 3)
        if mask is not None:
            mask = mask.transpose(2, 3)
    n = max(1, min(n, dist.shape[2]))
    if generator is not None:
        dist = dist + eps * torch.rand(
            dist.shape, generator=generator, dtype=dist.dtype, device=dist.device
        )
    if mask is None:
        mask = dist > inf  # all False unless dist is already saturated
    m = mask
    selected = torch.zeros(dist.shape, dtype=torch.bool, device=dist.device)
    for _ in range(n):
        mn = mmin(dist, mask=m, axis=(-1, -2), keepdims=True, ctt=inf)
        selected = selected | ((dist <= mn) & ~m)
        row_hit = mmin(dist, mask=m, axis=-1, keepdims=True, ctt=inf) <= mn
        col_hit = mmin(dist, mask=m, axis=-2, keepdims=True, ctt=inf) <= mn
        m = m | row_hit | col_hit
    return ordered_selected_mean(dist, selected, eps)


def _flatten_tail(x):
    b1, b2, s1, s2 = x.shape
    return x.reshape(b1, b2, 1, s1 * s2)


def _flatten_tail_2(x):
    """(b1, b2, s1, 1) -> (b1, b2, s1)."""
    b1, b2, s1, s2 = x.shape
    return x.reshape(b1, b2, s1 * s2)


def distance_tensor_redux(
    dist,
    redux: str,
    mask=None,
    squeeze: bool = True,
    eps: float = 1e-7,
    inf: float = 1e12,
    generator: Optional[torch.Generator] = None,
):
    """Reduce (b1, b2, s1, s2) segment distances to (b1, b2) song distances.

    Modes: ``min``, ``max``, ``mean``, ``minmean``, ``meanmin``, ``randmin``,
    ``bpwr[-n]``, ``best[-k]``, ``worst[-k]``, ``bestmin[-k]``, and the
    symmetric ``s<mode>`` (mean of both orientations). ``randmin`` needs a
    ``generator``; with one, ``bpwr`` adds ``eps``-scale tie-breaking jitter.
    """
    if redux.startswith("bestmin"):
        # dispatched before "best", which would match it too
        k = 1 if "-" not in redux else max(1, min(int(redux.split("-")[-1]), dist.shape[2]))
        d = mmin(dist, mask=mask, axis=-1, keepdims=True, ctt=inf)
        m = None if mask is None else mask.all(dim=-1, keepdim=True)
        d = mbest(_flatten_tail_2(d), k, mask=None if m is None else _flatten_tail_2(m),
                  axis=-1, keepdims=True, ctt=inf, eps=eps)
        d = d[..., None]
    elif redux == "min":
        d = mmin(dist, mask=mask, axis=(-1, -2), keepdims=True, ctt=inf)
    elif redux == "max":
        d = mmax(dist, mask=mask, axis=(-1, -2), keepdims=True, ctt=-inf)
    elif redux == "mean":
        d = mmean(dist, mask=mask, axis=(-1, -2), keepdims=True, eps=eps)
    elif redux == "minmean":
        d = mmean(dist, mask=mask, axis=-1, keepdims=True, eps=eps)
        if mask is not None:  # the reference's broadcast in the second stage
            d = d.expand(mask.shape)
        d = mmin(d, mask=mask, axis=(-1, -2), keepdims=True, ctt=inf)
    elif redux == "meanmin":
        d = mmin(dist, mask=mask, axis=-1, keepdims=True, ctt=inf)
        if mask is not None:  # count-weighted mean of row minima, as the reference
            d = d.expand(mask.shape)
        d = mmean(d, mask=mask, axis=(-1, -2), keepdims=True, eps=eps)
    elif redux == "randmin":
        if generator is None:
            raise ValueError("redux='randmin' requires a torch.Generator")
        d = mmin(dist, mask=mask, axis=-1, keepdims=True, ctt=inf)
        m = None if mask is None else mask.all(dim=-1, keepdim=True)
        d = mrand(d, generator, mask=m, axis=(-1, -2), keepdims=True, ctt=inf, eps=eps)
    elif redux.startswith("bpwr"):
        n = dist.shape[2] if "-" not in redux else int(redux.split("-")[-1])
        d = _bpwr(dist, mask, n, eps, inf, generator)
    elif redux.startswith("best") or redux.startswith("worst"):
        k = 1 if "-" not in redux else max(
            1, min(int(redux.split("-")[-1]), dist.shape[2] * dist.shape[3])
        )
        m = None if mask is None else _flatten_tail(mask.expand(dist.shape))
        if redux.startswith("best"):
            d = mbest(_flatten_tail(dist), k, mask=m, axis=-1, keepdims=True, ctt=inf, eps=eps)
        else:
            d = mworst(_flatten_tail(dist), k, mask=m, axis=-1, keepdims=True, ctt=-inf, eps=eps)
    elif redux.startswith("s"):
        aux1 = distance_tensor_redux(
            dist, redux[1:], mask=mask, squeeze=False, eps=eps, inf=inf, generator=generator
        )
        mask_t = None if mask is None else mask.transpose(2, 3)
        aux2 = distance_tensor_redux(
            dist.transpose(2, 3), redux[1:], mask=mask_t, squeeze=False, eps=eps, inf=inf,
            generator=generator,
        )
        d = 0.5 * (aux1 + aux2.transpose(2, 3))
    else:
        raise NotImplementedError(f"unknown redux mode: {redux!r}")
    if squeeze:
        d = d.reshape(d.shape[0], d.shape[1])
    return d
