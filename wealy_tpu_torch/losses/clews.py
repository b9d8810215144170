"""CLEWS loss (cosine-geometry vector variant), the counterpart of
``wealy_tpu.losses.clews``:

- alignment: per-anchor mean positive cosine distance, averaged over the
  anchors that have a positive;
- uniformity: per-anchor log1p(mean over negatives of exp(b - gamma * d)),
  its weight warmed up linearly from 0 to ``uniformity_weight`` over
  ``warmup_steps``, the step read from ``extra["global_step"]``.

``v_dpos`` / ``v_dneg`` are the mean distances over positive / negative
pairs (the JAX package's reading of the reference's intent).
"""

from __future__ import annotations

import torch

from wealy_tpu_torch.losses.common import pos_neg_masks, stabilize_labels


def _per_anchor_mean(x, mask, eps: float = 1e-8):
    """Per-anchor mean over dim 1 of the mask=True entries: (B, B) -> (B,)."""
    w = mask.to(x.dtype)
    return (x * w).sum(dim=1) / w.sum(dim=1).clamp(min=eps)


def clews_loss(
    z_label,
    z_idx,
    z,
    extra=None,
    gamma: float = 8.0,
    b: float = 1.0,
    eps: float = 1e-8,
    epsilon: float = 1e-6,
    uniformity_weight: float = 0.5,
    warmup_steps: int = 1000,
    numerically_friendly: bool = True,
):
    """CLEWS loss. Returns (loss, logdict)."""
    if z.ndim == 3:
        if z.shape[1] != 1:
            raise ValueError(f"CLEWS (vector) expects S=1, got S={z.shape[1]}")
        z = z[:, 0, :]
    B = z.shape[0]
    if z.ndim != 2 or z_label.shape[0] != B or z_idx.shape[0] != B or B < 4:
        raise ValueError(
            f"clews_loss needs z (B, zdim) with B >= 4 and B labels/ids; got z "
            f"{tuple(z.shape)}, labels {tuple(z_label.shape)}, ids {tuple(z_idx.shape)}"
        )

    z_label = stabilize_labels(z_label)
    pos_mask, neg_mask = pos_neg_masks(z_label, z_idx)

    zn = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp(min=1e-12)
    d = 1.0 - zn @ zn.T  # cosine distance in [0, 2]

    align_i = _per_anchor_mean(d, pos_mask, eps=eps)
    has_pos = pos_mask.any(dim=1)
    n_has_pos = has_pos.sum()
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    loss_align = torch.where(has_pos, align_i, zero).sum() / n_has_pos.clamp(min=1)

    uni_i = _per_anchor_mean(torch.exp(b - gamma * d), neg_mask, eps=eps)
    if numerically_friendly:
        loss_uniform = torch.log1p(uni_i).mean()
    else:
        loss_uniform = torch.log(uni_i + epsilon).mean()

    uw = torch.tensor(uniformity_weight, dtype=d.dtype, device=d.device)
    if warmup_steps > 0 and isinstance(extra, dict) and "global_step" in extra:
        uw = torch.minimum(uw, uw * (extra["global_step"] + 1) / warmup_steps)

    loss = loss_align + uw * loss_uniform

    n_pos_pairs = pos_mask.to(d.dtype).sum()
    n_neg_pairs = neg_mask.to(d.dtype).sum()
    v_dpos = torch.where(n_pos_pairs > 0, (d * pos_mask).sum() / n_pos_pairs.clamp(min=eps), zero)
    v_dneg = torch.where(n_neg_pairs > 0, (d * neg_mask).sum() / n_neg_pairs.clamp(min=eps), zero)
    logdict = {
        "l_main": loss,
        "l_cent": loss_align,
        "l_cont": loss_uniform,
        "cnt_pos_pairs": n_pos_pairs,
        "cnt_neg_pairs": n_neg_pairs,
        "anchors_with_pos": has_pos.to(d.dtype).mean(),
        "v_dpos": v_dpos,
        "v_dneg": v_dneg,
        "uniformity_weight": uw,
        "z_max": zn.abs().max(),
        "z_mean": zn.mean(),
        "z_std": zn.std(correction=1),
    }
    return loss, logdict


class CLEWSLoss:
    """Callable holding the CLEWS hyperparameters."""

    def __init__(
        self,
        gamma: float = 8.0,
        b: float = 1.0,
        eps: float = 1e-8,
        epsilon: float = 1e-6,
        uniformity_weight: float = 0.5,
        warmup_steps: int = 1000,
    ):
        self.gamma = float(gamma)
        self.b = float(b)
        self.eps = float(eps)
        self.epsilon = float(epsilon)
        self.uniformity_weight = float(uniformity_weight)
        self.warmup_steps = int(warmup_steps)

    def __call__(self, z_label, z_idx, z, extra=None, numerically_friendly=True):
        return clews_loss(
            z_label, z_idx, z, extra=extra, gamma=self.gamma, b=self.b, eps=self.eps,
            epsilon=self.epsilon, uniformity_weight=self.uniformity_weight,
            warmup_steps=self.warmup_steps, numerically_friendly=numerically_friendly,
        )
