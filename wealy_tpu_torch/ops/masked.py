"""Masked reductions (mask: True = excluded): the counterpart of
``wealy_tpu.ops.masked``.

``axis`` is None (every axis), an int, or a sequence of ints; excluded
entries are filled before the reduction exactly as the JAX package does.
Randomised reductions take an explicit ``torch.Generator`` (the JAX package
takes a PRNG key); the two give different numbers from the same seed.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

Axis = Union[None, int, Sequence[int]]

_EPS = 1e-7


def _axes(x: torch.Tensor, axis: Axis) -> tuple:
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, int):
        return (axis % x.ndim,)
    return tuple(a % x.ndim for a in axis)


def _fill(x: torch.Tensor, mask, value: float) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask, torch.tensor(value, dtype=x.dtype, device=x.device), x)


def msum(x, mask=None, axis: Axis = None, keepdims: bool = False):
    """Masked sum."""
    return _fill(x, mask, 0.0).sum(dim=_axes(x, axis), keepdim=keepdims)


def mmean(x, mask=None, axis: Axis = None, keepdims: bool = False, eps: float = _EPS):
    """Masked mean with an eps-clamped denominator."""
    if mask is None:
        included = torch.ones_like(x)
    else:
        included = (~mask).to(x.dtype)
    # where (not multiply) so excluded inf/nan entries cannot poison the sum
    axes = _axes(x, axis)
    num = _fill(x, mask, 0.0).sum(dim=axes, keepdim=keepdims)
    den = included.expand(x.shape).sum(dim=axes, keepdim=keepdims)
    return num / den.clamp(min=eps)


def mmin(x, mask=None, axis: Axis = None, keepdims: bool = False, ctt: float = float("inf")):
    """Masked min; excluded entries are filled with ``ctt``."""
    return _fill(x, mask, ctt).amin(dim=_axes(x, axis), keepdim=keepdims)


def mmax(x, mask=None, axis: Axis = None, keepdims: bool = False, ctt: float = -float("inf")):
    """Masked max; excluded entries are filled with ``ctt``."""
    return _fill(x, mask, ctt).amax(dim=_axes(x, axis), keepdim=keepdims)


def mrand(
    x,
    generator: torch.Generator,
    mask=None,
    axis: Axis = None,
    keepdims: bool = False,
    ctt: float = float("inf"),
    eps: float = _EPS,
):
    """One random unmasked entry per reduction group (the rand+min trick):
    uniform noise, +``ctt`` on excluded entries, and the mean of ``x`` over
    the position holding the smallest noise."""
    r = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    r = _fill(r, mask, ctt)
    mr = r > mmin(r, mask=mask, axis=axis, keepdims=True, ctt=ctt)
    return mmean(x, mask=mr, axis=axis, keepdims=keepdims, eps=eps)


def _topk(x, k: int, axis: int, largest: bool) -> torch.Tensor:
    return torch.topk(x, k, dim=axis, largest=largest, sorted=True).values


def mbest(
    x,
    k: int,
    mask=None,
    axis: int = -1,
    keepdims: bool = False,
    ctt: float = float("inf"),
    eps: float = _EPS,
):
    """Mean of the k smallest unmasked entries along ``axis``; selected
    entries still at ``ctt`` (fewer than k valid entries) are dropped."""
    if not isinstance(axis, int):
        raise TypeError("mbest requires a single int axis")
    x = _topk(_fill(x, mask, ctt), k, axis, largest=False)
    return mmean(x, mask=x >= ctt, axis=axis, keepdims=keepdims, eps=eps)


def mworst(
    x,
    k: int,
    mask=None,
    axis: int = -1,
    keepdims: bool = False,
    ctt: float = -float("inf"),
    eps: float = _EPS,
):
    """Mean of the k largest unmasked entries along ``axis`` (see :func:`mbest`)."""
    if not isinstance(axis, int):
        raise TypeError("mworst requires a single int axis")
    x = _topk(_fill(x, mask, ctt), k, axis, largest=True)
    return mmean(x, mask=x <= ctt, axis=axis, keepdims=keepdims, eps=eps)
