"""Building blocks of the projection heads: the counterpart of
``wealy_tpu.models.layers`` (``mean_pool``, ``MeanPool``, ``ConvBlock``; the
CLEWS blocks come with the CLEWS/fusion slice).

Layout: channel-last (B, T, C) at every public function, as in the JAX
package; the convolution transposes to torch's (B, C, T) inside. Masks here
are True = valid (the layer convention), the opposite of ``ops``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def mean_pool(x, mask=None, eps: float = 1e-8):
    """Masked mean over time: x (B, T, C), mask (B, T) True=valid -> (B, C)."""
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / (m.sum(dim=1) + eps)


class MeanPool(nn.Module):
    """Module wrapper around :func:`mean_pool`."""

    def forward(self, x, mask=None):
        return mean_pool(x, mask)


class ConvBlock(nn.Module):
    """Conv1d (no bias) -> ReLU -> LayerNorm over channels in f32.
    x: (B, T, C_in) -> (B, ceil(T / stride), features)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(
            in_features, features, kernel_size, stride=stride, padding=kernel_size // 2,
            bias=False,
        )
        self.norm = nn.LayerNorm(features, eps=1e-5)

    def forward(self, x):
        x = F.relu(self.conv(x.transpose(1, 2))).transpose(1, 2)
        return self.norm(x.float())
