"""Small numeric utilities, the counterpart of ``wealy_tpu.ops.misc`` (the
reference's ``tensor_quantile``, ``covariance``, ``roughly_equal`` and
``debug_inf_nan``, lib/tensor_ops.py:8-29, 113-125). The reference's
print-and-exit ``debug_inf_nan`` becomes :func:`check_finite`, which
returns the verdict to the caller."""

from __future__ import annotations

import torch


def tensor_quantile(x, q, axis: int = -1, keepdims: bool = False) -> torch.Tensor:
    """Nearest-rank quantile along ``axis`` by sort and gather; ``q`` has the
    rank of ``x`` (broadcast along ``axis``), as the reference's contract
    (lib/tensor_ops.py:8-15). The rank rounds half to even, as
    ``jnp.round``."""
    x, q = torch.as_tensor(x), torch.as_tensor(q)
    assert x.ndim == q.ndim
    axis = axis % x.ndim
    qn = torch.round(q.clamp(0.0, 1.0) * (x.shape[axis] - 1)).long()
    xq = torch.take_along_dim(torch.sort(x, dim=axis).values, qn, dim=axis)
    return xq if keepdims else xq.squeeze(axis)


def covariance(x, eps: float = 1e-6) -> torch.Tensor:
    """Mean squared off-diagonal (upper triangle) covariance, the
    decorrelation regulariser (lib/tensor_ops.py:113-118). x: (N, C)."""
    x = torch.as_tensor(x)
    xx = x - x.mean(dim=0, keepdim=True)
    cov = (xx.T @ xx) / (x.shape[0] - 1)
    weight = torch.triu(torch.ones_like(cov), diagonal=1)
    return (weight * cov**2).sum() / (weight.sum() + eps)


def roughly_equal(x, y, tol: float = 1e-6) -> torch.Tensor:
    return (torch.as_tensor(x) - torch.as_tensor(y)).abs() < tol


def check_finite(x, name: str = "tensor"):
    """NaN/Inf guard: (is_finite as a bool tensor, x), with no host sync;
    the caller decides what to do with a non-finite tensor (see also
    ``torch.autograd.set_detect_anomaly`` for debug runs)."""
    del name
    x = torch.as_tensor(x)
    return torch.isfinite(x).all(), x
