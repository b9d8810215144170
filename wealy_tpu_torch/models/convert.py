"""Weight bridge from the JAX package's flax modules into the port's
modules of the same structure (the heads, the fusion models, the CLEWS
encoder and its blocks).

:func:`head_state_dict_from_jax_params` takes a flax param tree (nested
dicts with numpy leaves, e.g. ``ProjectionHead.init(...)["params"]``) and,
optionally, its ``batch_stats`` tree, and returns the port module's state
dict. Each leaf is read by its path, not by its rank alone:

- Dense kernel (in, out) -> Linear weight (out, in); bias -> bias;
- Conv kernel (k, C_in, C_out) -> Conv1d weight (C_out, C_in, k);
- Conv kernel (kh, kw, C_in, C_out) (HWIO) -> Conv2d weight (C_out, C_in,
  kh, kw) (OIHW);
- ``MultiHeadDotProductAttention``: a rank-3 kernel under ``query``,
  ``key`` or ``value`` is (in, heads, head_dim) -> Linear weight
  (heads * head_dim, in), its bias (heads, head_dim) -> (heads * head_dim,);
  the rank-3 ``out`` kernel (heads, head_dim, out) -> Linear weight (out,
  heads * head_dim). Read by rank alone they would pass for Conv1d kernels
  and be permuted silently;
- LayerNorm / BatchNorm / InstanceNorm ``scale`` -> ``weight``;
- the blocks' own parameters (``gain``, GeM's and AutoPool's ``p``) keep
  their names and shapes;
- ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var`` of the port's flax-semantics ``BatchNorm``.

:func:`layer_norm_state_dict_from_jax_params` carries a flax
``LayerNormFused`` (``{"scale", "bias"}``) into the port's
``LayerNormFused``, whose parameters keep the flax names.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

_ATTN_IN = ("query", "key", "value")
_KEEP = ("gain", "p")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a writable copy


def _leaf(path: tuple, value) -> tuple[str, torch.Tensor]:
    """(port name, tensor) of the flax leaf at ``path`` (its last element is
    the leaf's own name, the one before it its module's)."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    a = np.asarray(value, dtype=np.float32)
    if parent in _ATTN_IN and a.ndim in (2, 3):
        if name == "kernel" and a.ndim == 3:  # (in, heads, head_dim)
            return "weight", _t(a.reshape(a.shape[0], -1).T)
        if name == "bias" and a.ndim == 2:  # (heads, head_dim)
            return "bias", _t(a.reshape(-1))
    if parent == "out" and name == "kernel" and a.ndim == 3:  # (heads, head_dim, out)
        return "weight", _t(a.reshape(-1, a.shape[-1]).T)
    if name == "kernel":
        if a.ndim == 4:  # HWIO -> OIHW
            return "weight", _t(a.transpose(3, 2, 0, 1))
        if a.ndim == 3:
            return "weight", _t(a.transpose(2, 1, 0))
        if a.ndim == 2:
            return "weight", _t(a.T)
        raise ValueError(f"kernel of rank {a.ndim} at {'/'.join(path)} has no torch counterpart")
    if name == "scale":
        return "weight", _t(a)
    if name == "bias" or name in _KEEP:
        return name, _t(a)
    raise ValueError(f"unknown flax parameter {'/'.join(path)}")


def _stat(path: tuple, value) -> tuple[str, torch.Tensor]:
    names = {"mean": "running_mean", "var": "running_var"}
    if path[-1] not in names:
        raise ValueError(f"unknown flax batch statistic {'/'.join(path)}")
    return names[path[-1]], _t(np.asarray(value, dtype=np.float32))


def head_state_dict_from_jax_params(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> dict[str, torch.Tensor]:
    """Flax params (and batch statistics) -> the port's state dict (f32
    tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, path: tuple, read) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,), read)
            else:
                name, tensor = read(path + (key,), value)
                out[".".join(path + (name,))] = tensor

    walk(params, (), _leaf)
    if batch_stats is not None:
        walk(batch_stats, (), _stat)
    return out


def layer_norm_state_dict_from_jax_params(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``LayerNormFused`` params -> the port's ``LayerNormFused`` state
    dict (the same names, f32 tensors)."""
    if set(params) != {"scale", "bias"}:
        raise ValueError(f"LayerNormFused params are scale and bias; got {sorted(params)}")
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32)) for k in ("scale", "bias")}
