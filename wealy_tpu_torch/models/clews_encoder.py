"""CLEWS acoustic encoder: CQT spectrogram -> IBN-ResNet CNN -> GeM -> 2048-d,
the counterpart of ``wealy_tpu.models.clews_encoder``.

Channel-first: the encoder takes (B, 1, F, T) where the JAX one takes
(B, F, T, 1); :class:`ClewsWindowEncoder` cuts the time axis into the same
windows as the JAX one, so each window holds the same frames. Parameter
names follow the flax modules (``prepare``, ``stem.conv``,
``stage<s>_block<b>``, ``gem``, ``proj``; the window encoder's
``encoder``), so that ``models/convert.py`` carries JAX weights and batch
statistics across.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import math

import torch
from torch import nn

from wealy_tpu_torch.models.layers import (
    BatchNorm,
    CQTPrepare,
    GeMPool,
    InstanceNorm,
    MyIBNResBlock,
    PadConv2d,
)


class ClewsEncoder(nn.Module):
    """CQTPrepare -> stem conv -> MyIBNResBlock stages -> GeM pool -> Linear.

    Input: (B, 1, F, T) CQT magnitude. Output: (B, embed_dim). CQTPrepare's
    eps-noise is drawn in training mode only, as the JAX encoder's
    ``add_noise=train``.
    """

    def __init__(self, embed_dim: int = 2048, stem: int = 64,
                 stages: Sequence[Tuple[int, int]] = ((64, 1), (128, 2), (256, 2), (512, 2)),
                 blocks_per_stage: int = 2, ibn: str = "pre", se: str = "none",
                 in_channels: int = 1):
        super().__init__()
        self.prepare = CQTPrepare()
        self.stem = PadConv2d(in_channels, stem, 7, stride=2, use_bias=False)
        self.blocks = []
        ncin = stem
        for si, (ncout, stride) in enumerate(stages):
            for bi in range(blocks_per_stage):
                name = f"stage{si}_block{bi}"
                self.add_module(name, MyIBNResBlock(ncin, ncout, stride=stride if bi == 0 else 1,
                                                    ibn=ibn, se=se))
                self.blocks.append(name)
                ncin = ncout
        self.gem = GeMPool(features=1)
        self.proj = nn.Linear(ncin, embed_dim)

    def forward(self, cqt):
        h = self.stem(self.prepare(cqt, add_noise=self.training))
        for name in self.blocks:
            h = getattr(self, name)(h)
        return self.proj(self.gem(h))


class ClewsWindowEncoder(nn.Module):
    """:class:`ClewsEncoder` per time window: (B, C, F, T) ->
    (B, n_windows, embed_dim), the layout of the ``hs_clews`` files. The
    time axis splits into ``n_windows`` equal slices, all of them one batch
    through the shared encoder."""

    def __init__(self, n_windows: int = 116, embed_dim: int = 2048, encoder_kwargs: dict = None):
        super().__init__()
        self.n_windows, self.embed_dim = n_windows, embed_dim
        self.encoder = ClewsEncoder(embed_dim=embed_dim, **(encoder_kwargs or {}))

    def forward(self, cqt):
        B, C, F, T = cqt.shape
        W = self.n_windows
        if T % W:
            raise ValueError(f"time axis {T} must divide into {W} windows")
        x = cqt.reshape(B, C, F, W, T // W).permute(0, 3, 1, 2, 4).reshape(B * W, C, F, T // W)
        return self.encoder(x).reshape(B, W, self.embed_dim)


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise a CLEWS encoder in place from ``torch.Generator`` seed
    ``seed``, on the CPU, so that every device gets the same weights. The
    values flax's initialisers give where they are constants (norm scales
    1, biases 0, running statistics 0 and 1, CQTPrepare's gain 1,
    MyIBNResBlock's gain 0, GeM's p for p = 3); convolution and linear
    weights normal with std sqrt(1 / fan_in) (flax's lecun-normal scale,
    not its truncated draw, and not JAX's numbers). Returns ``model``."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            w.copy_(torch.randn(w.shape, generator=gen) * w[0].numel() ** -0.5)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (BatchNorm, InstanceNorm)):
            if module.weight is not None:
                module.weight.fill_(1.0)
                module.bias.zero_()
            if isinstance(module, BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        elif isinstance(module, CQTPrepare) and module.affine:
            module.gain.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, MyIBNResBlock):
            module.gain.zero_()
        elif isinstance(module, GeMPool):
            module.p.fill_(math.log(math.exp(3.0 - 1.0) - 1.0))
    return model
