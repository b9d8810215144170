"""Mask-convention converters, the counterpart of ``wealy_tpu.utils.masks``.

Two opposite boolean mask conventions meet in this code base:

- **ops convention** (``wealy_tpu_torch.ops``, the reference's
  lib/tensor_ops.py): True = excluded;
- **layer convention** (``wealy_tpu_torch.models.layers``, the reference's
  lib/layers.py MeanPool, the audio collates' attention masks): True = valid.

Convert at module boundaries with these helpers, so that the intent can be
searched for.
"""

import torch


def valid_to_excluded(mask) -> torch.Tensor:
    """Layer convention (True = valid) -> ops convention (True = excluded)."""
    return torch.logical_not(torch.as_tensor(mask))


def excluded_to_valid(mask) -> torch.Tensor:
    """Ops convention (True = excluded) -> layer convention (True = valid)."""
    return torch.logical_not(torch.as_tensor(mask))
