"""Shared helpers of the losses (``wealy_tpu.losses.common``)."""

from __future__ import annotations

import torch


def stabilize_labels(z_label: torch.Tensor) -> torch.Tensor:
    """If the batch has a single unique label (no negatives), the first
    max(2, 1% of B) labels become -1 (the reference's in-place flip, as a
    select)."""
    B = z_label.shape[0]
    all_same = (z_label == z_label[0]).all()
    flip = torch.arange(B, device=z_label.device) < max(2, int(0.01 * B))
    flipped = torch.where(flip, torch.full_like(z_label, -1), z_label)
    return torch.where(all_same, flipped, z_label)


def pos_neg_masks(z_label: torch.Tensor, z_idx: torch.Tensor):
    """Boolean (B, B) masks, True = member of the pair set. Positives: same
    label and different idx; negatives: different label."""
    same_label = z_label[:, None] == z_label[None, :]
    same_idx = z_idx[:, None] == z_idx[None, :]
    return same_label & ~same_idx, ~same_label


def z_stats(z: torch.Tensor) -> dict:
    """Embedding statistics shared by every loss logdict."""
    return {
        "v_zmax": z.abs().max(),
        "v_zmean": z.mean(),
        "v_zstd": z.std(correction=1),
    }
