"""Building blocks of the projection heads: the counterpart of
``wealy_tpu.models.layers`` (``LayerNormFused``, ``mean_pool``, ``MeanPool``,
``ConvBlock``; the CLEWS blocks come with the CLEWS/fusion slice).

Layout: channel-last (B, T, C) at every public function, as in the JAX
package; the convolution transposes to torch's (B, C, T) inside. Masks here
are True = valid (the layer convention), the opposite of ``ops``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wealy_tpu_torch.ops.layer_norm import fused_layer_norm


class LayerNormFused(nn.Module):
    """LayerNorm over the last axis through K6 (``ops/layer_norm.py``): f32
    parameters ``scale`` (ones) and ``bias`` (zeros), named as flax's
    ``nn.LayerNorm`` so that converted params load unchanged; f32 statistics,
    output in the input's dtype. ``in_features`` is the width D (flax infers
    it). The encoder does not use it: it keeps ``F.layer_norm`` in f32, as
    the JAX encoder keeps ``nn.LayerNorm``."""

    def __init__(self, in_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(in_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(in_features, dtype=torch.float32))

    def forward(self, x):
        return fused_layer_norm(x, self.scale, self.bias, self.epsilon)


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
    """Conv1d (no bias) -> ReLU -> LayerNorm over channels in f32, the
    result in the convolution's dtype (as flax's ``.astype(dtype)``).
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
        return self.norm(x.float()).to(x.dtype)
