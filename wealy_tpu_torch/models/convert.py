"""Weight bridge from the JAX package's flax heads into the port's heads.

:func:`head_state_dict_from_jax_params` takes a flax param tree (nested
dicts with numpy leaves, e.g. ``ProjectionHead.init(...)["params"]``) and
returns the state dict of the port's module of the same structure:

- Conv kernel (k, C_in, C_out) -> Conv1d weight (C_out, C_in, k)
- Dense kernel (in, out) -> Linear weight (out, in)
- LayerNorm scale / bias -> weight / bias; Dense bias -> bias

:func:`layer_norm_state_dict_from_jax_params` carries a flax
``LayerNormFused`` (``{"scale", "bias"}``) into the port's
``LayerNormFused``, whose parameters keep the flax names.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _leaf(name: str, value) -> tuple[str, torch.Tensor]:
    a = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        if a.ndim == 3:
            return "weight", torch.from_numpy(np.ascontiguousarray(a.transpose(2, 1, 0)))
        if a.ndim == 2:
            return "weight", torch.from_numpy(np.ascontiguousarray(a.T))
        raise ValueError(f"kernel of rank {a.ndim} has no torch counterpart here")
    if name == "scale":
        return "weight", torch.from_numpy(a.copy())
    if name == "bias":
        return "bias", torch.from_numpy(a.copy())
    raise ValueError(f"unknown flax parameter {name!r}")


def head_state_dict_from_jax_params(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax head params -> the port's state dict (f32 tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
            else:
                name, tensor = _leaf(key, value)
                out[prefix + name] = tensor

    walk(params, "")
    return out


def layer_norm_state_dict_from_jax_params(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``LayerNormFused`` params -> the port's ``LayerNormFused`` state
    dict (the same names, f32 tensors)."""
    if set(params) != {"scale", "bias"}:
        raise ValueError(f"LayerNormFused params are scale and bias; got {sorted(params)}")
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32)) for k in ("scale", "bias")}
