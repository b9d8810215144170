"""Projection heads: Whisper-embedding sequences -> metric-space vectors, the
counterpart of ``wealy_tpu.models.heads``.

A ConvBlock stack over the (B, T, C_in) embedding sequence with optional
temporal striding, then (``ProjectionHead``) a masked mean pool and a linear
projection to ``zdim``, or (``SequenceProjectionHead``) the projection of
every step. Parameter names follow the flax modules (``conv_<i>.conv``,
``conv_<i>.norm``, ``proj``) so that ``models/convert.py`` carries JAX
weights across. Torch needs ``in_features`` up front where flax infers it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from wealy_tpu_torch.models.layers import ConvBlock, mean_pool


class _ConvStack(nn.Module):
    def __init__(self, in_features: int, zdim: int, hidden: Sequence[int], kernel_size: int,
                 strides: Optional[Sequence[int]]):
        super().__init__()
        self.strides = tuple(strides or (1,) * len(hidden))
        if len(self.strides) != len(hidden):
            raise ValueError(f"strides {self.strides} and hidden {tuple(hidden)} differ in length")
        self.n_blocks = len(hidden)
        c_in = in_features
        for i, (c, s) in enumerate(zip(hidden, self.strides)):
            self.add_module(f"conv_{i}", ConvBlock(c_in, c, kernel_size=kernel_size, stride=s))
            c_in = c
        self.proj = nn.Linear(c_in, zdim)

    def _convs(self, x, mask):
        for i, s in enumerate(self.strides):
            x = getattr(self, f"conv_{i}")(x)
            if mask is not None and s > 1:
                mask = mask[:, ::s]
        return x, mask


class ProjectionHead(_ConvStack):
    """ConvBlock stack + masked mean pool + Linear(zdim).

    x: (B, T, C_in); mask: (B, T) True=valid. Returns (B, zdim), on the unit
    sphere with ``l2_normalize``.
    """

    def __init__(self, in_features: int, zdim: int = 512, hidden: Sequence[int] = (512, 512),
                 kernel_size: int = 3, strides: Optional[Sequence[int]] = None,
                 l2_normalize: bool = False):
        super().__init__(in_features, zdim, hidden, kernel_size, strides)
        self.l2_normalize = l2_normalize

    def forward(self, x, mask=None):
        x, mask = self._convs(x, mask)
        z = self.proj(mean_pool(x, mask))
        if self.l2_normalize:
            z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp(min=1e-12)
        return z


class SequenceProjectionHead(_ConvStack):
    """Like :class:`ProjectionHead` but keeps time: (B, T, C_in) ->
    ((B, T', zdim), mask (B, T') or None)."""

    def __init__(self, in_features: int, zdim: int = 512, hidden: Sequence[int] = (512,),
                 kernel_size: int = 3, strides: Optional[Sequence[int]] = None):
        super().__init__(in_features, zdim, hidden, kernel_size, strides)

    def forward(self, x, mask=None):
        x, mask = self._convs(x, mask)
        return self.proj(x), mask


@torch.no_grad()
def seeded_init_(head: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise a head in place from ``torch.Generator`` seed ``seed``, on
    the CPU, so that every device gets the same weights: conv and linear
    weights normal with std sqrt(1 / fan_in) (flax's lecun-normal scale,
    not its truncated draw, and not JAX's numbers), biases 0, LayerNorm
    scale 1. The fusion models of ``models/fusion.py`` take it too.
    Returns ``head``."""
    gen = torch.Generator().manual_seed(seed)
    norms = {f"{name}.weight" for name, m in head.named_modules() if isinstance(m, nn.LayerNorm)}
    for name, p in head.named_parameters():
        if name in norms:
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            fan_in = p[0].numel()  # (out, in[, k]) -> in * k
            w = torch.randn(p.shape, generator=gen) * fan_in**-0.5
            p.copy_(w)
    return head
