"""Pairwise distance matrices: the counterpart of ``wealy_tpu.ops.distance``.

Every mode with a product at its core is one (B1, C) @ (C, B2)
``torch.matmul``, as the JAX package left it to XLA. The product is float32;
on the card it is full float32 unless the caller turns TF32 on.
"""

from __future__ import annotations

import torch


def pairwise_euclidean_distance_matrix(x, y, squared: bool = False, eps: float = 1e-6):
    """Euclidean distances by x^2 - 2xy + y^2, negatives clamped to 0; on
    the sqrt path exact zeros are lifted to ``eps`` before the sqrt and
    zeroed after (the reference's stabilisation)."""
    squared_x = (x * x).sum(dim=1)[:, None]
    squared_y = (y * y).sum(dim=1)[None, :]
    d = squared_x - 2.0 * (x @ y.T) + squared_y
    d = torch.where(d <= 0.0, torch.zeros((), dtype=d.dtype, device=d.device), d)
    if not squared:
        zero = (d == 0.0).to(d.dtype)
        d = torch.sqrt(d + zero * eps) * (1.0 - zero)
    return d


def pairwise_distance_matrix(x, y, mode: str = "fro", p: float = 2, eps: float = 1e-6):
    """Distance or similarity matrix between the rows of x and y.

    Modes: ``fro``/``nfro`` (p-norm; ``n`` divides by C**(1/p)),
    ``euc``/``neuc`` (p=2), ``sqeuc``/``nsqeuc`` (squared; ``n`` divides by
    C), ``cos``/``cossim`` (1 - cosine / cosine, L2 norm + eps) and
    ``dot``/``dotsim`` (1 - dot / dot).
    """
    if x.ndim != y.ndim or x.ndim > 2:
        raise ValueError(f"x and y must both be 1-D or 2-D; got {x.ndim}-D and {y.ndim}-D")
    if x.ndim == 1:
        x = x[:, None]
        y = y[:, None]
    if mode in ("euc", "neuc"):
        p = 2
    if mode in ("fro", "nfro", "euc", "neuc"):
        if p == 2:
            dist = pairwise_euclidean_distance_matrix(x, y, squared=False)
        else:
            diff = (x[:, None, :] - y[None, :, :]).abs()
            dist = (diff**p).sum(dim=-1) ** (1.0 / p)
        if mode in ("nfro", "neuc"):
            dist = dist / (x.shape[-1] ** (1.0 / p))
    elif mode in ("sqeuc", "nsqeuc"):
        dist = pairwise_euclidean_distance_matrix(x, y, squared=True)
        if mode == "nsqeuc":
            dist = dist / x.shape[-1]
    elif mode in ("cos", "cossim", "dot", "dotsim"):
        if mode in ("cos", "cossim"):
            x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
            y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + eps)
        dist = x @ y.T
        if mode in ("cos", "dot"):
            dist = 1.0 - dist
    else:
        raise NotImplementedError(f"unknown pairwise distance mode: {mode!r}")
    return dist
