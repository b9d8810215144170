"""NT-Xent contrastive loss on cosine similarity, the counterpart of
``wealy_tpu.losses.ntxent``: logits = cos_sim / tau with the diagonal set
to -1e9 and the (gradient-free) row max subtracted; loss =
-mean(log(sum(pos_exp) / (sum(all_exp) + eps) + eps))."""

from __future__ import annotations

import torch

from wealy_tpu_torch.losses.common import pos_neg_masks, stabilize_labels, z_stats
from wealy_tpu_torch.ops.distance import pairwise_distance_matrix


def ntxent_loss(z_label, z_idx, z, extra=None, temperature: float = 0.1):
    """NT-Xent loss. Returns (loss, logdict)."""
    del extra
    z_label = stabilize_labels(z_label)
    positives, _ = pos_neg_masks(z_label, z_idx)
    logits = pairwise_distance_matrix(z, z, mode="cossim") / temperature
    B = logits.shape[0]
    diag = torch.eye(B, dtype=torch.bool, device=logits.device)
    logits = logits.masked_fill(diag, -1e9)
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    exp_logits = torch.exp(logits)
    pos_exp_sum = (exp_logits * positives.to(exp_logits.dtype)).sum(dim=1)
    all_exp_sum = exp_logits.sum(dim=1)
    eps = 1e-8
    loss = -torch.log(pos_exp_sum / (all_exp_sum + eps) + eps).mean()
    return loss, {"l_main": loss, **z_stats(z)}


class NTXentLoss:
    """Callable holding the temperature."""

    def __init__(self, temperature: float = 0.1):
        self.tau = float(temperature)

    def __call__(self, z_label, z_idx, z, extra=None):
        return ntxent_loss(z_label, z_idx, z, extra=extra, temperature=self.tau)
