"""Triplet margin loss with first-valid mining, the counterpart of
``wealy_tpu.losses.triplet``: per anchor the first positive (same label,
other idx) and the first negative (other label) by masked argmax; distance
d(a, b) = ||a - b + eps||_p as ``torch.nn.TripletMarginLoss``; loss =
mean(relu(d_ap - d_an + margin)) over the anchors that have both, 0.0 when
none has."""

from __future__ import annotations

import torch

from wealy_tpu_torch.losses.common import pos_neg_masks, stabilize_labels, z_stats


def _pairwise_p_distance(a, b, p: float, eps: float):
    return ((a - b + eps).abs() ** p).sum(dim=-1) ** (1.0 / p)


def triplet_loss(
    z_label,
    z_idx,
    z,
    extra=None,
    margin: float = 0.2,
    p: float = 2,
    eps: float = 1e-6,
    swap: bool = False,
):
    """Triplet margin loss. Returns (loss, logdict)."""
    del extra
    z_label = stabilize_labels(z_label)
    pos_mask, neg_mask = pos_neg_masks(z_label, z_idx)
    # argmax of a 0/1 row is its first True (torch returns the first maximum)
    pos_idx = pos_mask.to(torch.uint8).argmax(dim=1)
    neg_idx = neg_mask.to(torch.uint8).argmax(dim=1)
    valid = pos_mask.any(dim=1) & neg_mask.any(dim=1)

    positive, negative = z[pos_idx], z[neg_idx]
    d_ap = _pairwise_p_distance(z, positive, p, eps)
    d_an = _pairwise_p_distance(z, negative, p, eps)
    if swap:
        d_an = torch.minimum(d_an, _pairwise_p_distance(positive, negative, p, eps))

    per_anchor = (d_ap - d_an + margin).clamp(min=0.0)
    n_valid = valid.sum()
    zero = torch.zeros((), dtype=per_anchor.dtype, device=per_anchor.device)
    loss = torch.where(valid, per_anchor, zero).sum() / n_valid.clamp(min=1)
    return loss, {"l_main": loss, "n_triplets": n_valid, **z_stats(z)}


class TripletLoss:
    """Callable holding the margin configuration."""

    def __init__(self, margin: float = 0.2, p: float = 2, eps: float = 1e-6, swap: bool = False):
        self.margin = float(margin)
        self.p = float(p)
        self.eps = float(eps)
        self.swap = bool(swap)

    def __call__(self, z_label, z_idx, z, extra=None):
        return triplet_loss(z_label, z_idx, z, extra=extra, margin=self.margin, p=self.p,
                            eps=self.eps, swap=self.swap)
