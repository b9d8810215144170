"""Building blocks of the heads and of the CLEWS encoder: the counterpart of
``wealy_tpu.models.layers`` (``LayerNormFused``, ``mean_pool``, ``MeanPool``,
``ConvBlock``, and the CLEWS blocks ``CQTPrepare``, ``AxisLinear``,
``PadConv2d``, ``InstanceNorm``, ``BatchNorm``, ``InstanceBatchNorm``,
``GeMPool``, ``AutoPool``, ``SoftPool``, ``SqueezeExcitation2d``,
``ResNet50BottBlock`` and ``MyIBNResBlock``).

Layout: the 1-D blocks are channel-last (B, T, C) at every public function,
as in the JAX package; the convolution transposes to torch's (B, C, T)
inside. The 2-D blocks are channel-first, torch's (B, C, H, W) (the JAX
package's are (B, H, W, C)); the pools take (B, C, *spatial). Masks here
are True = valid (the layer convention), the opposite of ``ops``. Torch
needs each block's input width up front where flax infers it.

``BatchNorm`` has flax's semantics, not ``nn.BatchNorm2d``'s: in training
it normalises with the biased batch variance and updates
``running_mean``/``running_var`` as ``0.9 * running + 0.1 * batch`` with
that same biased variance (``nn.BatchNorm2d`` would store the unbiased
one); in eval mode it reads the running statistics. Blocks train or not by
the module's mode (``model.train()``), where the JAX blocks take ``train``.
"""

from __future__ import annotations

import math

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


# ---------------------------------------------------------------------------
# CLEWS blocks (2-D, channel-first)
# ---------------------------------------------------------------------------


class CQTPrepare(nn.Module):
    """CQT input conditioning: clamp >= 0, power, normalize over (H, W),
    eps-noise, affine. h: (B, C, H, W) (freq, time). ``add_noise`` draws
    uniform noise from ``generator`` (torch's default one when None); it is
    eps-small, so its draw does not show at f32 tolerances."""

    def __init__(self, pow: float = 0.5, norm: str = "max2d", noise: bool = True,
                 affine: bool = True, eps: float = 1e-6):
        super().__init__()
        if norm not in ("max1d", "max2d", "mean2d"):
            raise ValueError(f"unknown norm {norm!r}")
        self.pow, self.norm, self.noise, self.affine, self.eps = pow, norm, noise, affine, eps
        if affine:
            self.gain = nn.Parameter(torch.ones(1))
            self.bias = nn.Parameter(torch.zeros(1))

    def _normalize(self, h):
        h = h - h.amin(dim=(2, 3), keepdim=True)
        if self.norm == "max2d":
            return h / (h.amax(dim=(2, 3), keepdim=True) + self.eps)
        if self.norm == "max1d":  # max over the freq dim only
            return h / (h.amax(dim=2, keepdim=True) + self.eps)
        return h / (h.mean(dim=(2, 3), keepdim=True) + self.eps)

    def forward(self, h, add_noise: bool = False, generator=None):
        h = self._normalize(h.clamp(min=0.0) ** self.pow)
        if self.noise and add_noise:
            r = torch.rand(h.shape, generator=generator, device=h.device, dtype=h.dtype)
            h = self._normalize(h + self.eps * r)
        if self.affine:
            h = self.gain * h + self.bias
        return h


class AxisLinear(nn.Module):
    """Linear applied along axis ``axis`` of any tensor."""

    def __init__(self, in_features: int, features: int, axis: int = -1, use_bias: bool = True):
        super().__init__()
        self.axis = axis
        self.lin = nn.Linear(in_features, features, bias=use_bias)

    def forward(self, h):
        last = self.axis in (-1, h.ndim - 1)
        if not last:
            h = h.transpose(self.axis, -1)
        h = self.lin(h)
        return h if last else h.transpose(self.axis, -1)


class PadConv2d(nn.Module):
    """Same-padding odd-kernel Conv2d."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 use_bias: bool = True):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"PadConv2d takes an odd kernel, got {kernel}")
        self.conv = nn.Conv2d(in_features, features, kernel, stride=stride, padding=kernel // 2,
                              bias=use_bias)

    def forward(self, h):
        return self.conv(h)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over the spatial dims of (B, C,
    *spatial) (+affine): torch.nn.InstanceNorm semantics (biased variance,
    eps inside the square root)."""

    def __init__(self, features: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(features)) if affine else None

    def forward(self, h):
        axes = tuple(range(2, h.ndim))
        var, mu = torch.var_mean(h, dim=axes, keepdim=True, unbiased=False)
        out = (h - mu) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            shape = (1, -1) + (1,) * len(axes)
            out = out * self.weight.view(shape) + self.bias.view(shape)
        return out


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon)`` over dim 1 of (B, C,
    *spatial): see the module docstring for how it differs from
    ``nn.BatchNorm2d``."""

    def __init__(self, features: int, affine: bool = True, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(features)) if affine else None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, h):
        if not self.training:
            return F.batch_norm(h, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        out = F.batch_norm(h, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            axes = (0,) + tuple(range(2, h.ndim))
            var, mean = torch.var_mean(h, dim=axes, unbiased=False)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return out


class InstanceBatchNorm(nn.Module):
    """IBN: the first half of the channels BatchNorm, the second half
    InstanceNorm; rank-generic over (B, C, *spatial)."""

    def __init__(self, features: int, affine: bool = True):
        super().__init__()
        if features % 2:
            raise ValueError(f"InstanceBatchNorm splits an even channel count, got {features}")
        self.half = features // 2
        self.bn = BatchNorm(self.half, affine=affine)
        self.inst = InstanceNorm(self.half, affine=affine)

    def forward(self, h):
        return torch.cat([self.bn(h[:, : self.half]), self.inst(h[:, self.half :])], dim=1)


def _spatial_last(h):
    """(B, C, *spatial) -> (B, S, C), the JAX pools' layout."""
    return h.reshape(h.shape[0], h.shape[1], -1).transpose(1, 2)


class GeMPool(nn.Module):
    """Generalized-mean pooling with learnable p = 1 + softplus(p_raw):
    (B, C, *spatial) -> (B, C). ``p`` has the flax shape (1, 1, features)."""

    def __init__(self, features: int = 1, p_init: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        pinit = math.log(math.exp(p_init - 1.0) - 1.0)
        self.p = nn.Parameter(torch.full((1, 1, features), pinit))

    def forward(self, h):
        p = 1.0 + F.softplus(self.p)
        h = _spatial_last(h).clamp(min=self.eps) ** p
        return h.mean(dim=1) ** (1.0 / p[:, 0, :])


class AutoPool(nn.Module):
    """Learnable-temperature softmax attention pooling: (B, C, *spatial) ->
    (B, C)."""

    def __init__(self, features: int = 1, p_init: float = 1.0):
        super().__init__()
        self.p = nn.Parameter(torch.full((1, 1, features), float(p_init)))

    def forward(self, h):
        h = _spatial_last(h)
        a = torch.softmax(self.p * h, dim=1)
        return (h * a).sum(dim=1)


class SoftPool(nn.Module):
    """Linear -> split (values, attention) -> InstanceNorm'd softmax weights:
    (B, C, *spatial) -> (B, features)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.lin = nn.Linear(in_features, 2 * features, bias=False)
        self.norm = InstanceNorm(features, affine=True)

    def forward(self, h):
        h = self.lin(_spatial_last(h))  # (B, S, 2F)
        vals, att = h[..., : self.features], h[..., self.features :]
        att = self.norm(att.transpose(1, 2)).transpose(1, 2)  # over S, per channel
        return (vals * torch.softmax(att, dim=1)).sum(dim=1)


class SqueezeExcitation2d(nn.Module):
    """Global average pool -> bottleneck MLP -> sigmoid channel gates. x:
    (B, C, H, W)."""

    def __init__(self, features: int, r: int = 2):
        super().__init__()
        nmid = max(1, features // r)
        self.fc1 = nn.Linear(features, nmid, bias=False)
        self.fc2 = nn.Linear(nmid, features, bias=False)

    def forward(self, h):
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(h.mean(dim=(2, 3))))))
        return h * s[:, :, None, None]


class ResNet50BottBlock(nn.Module):
    """1x1 -> kxk(stride) -> 1x1 bottleneck with BN/IBN, optional SE, conv-BN
    shortcut on shape change."""

    def __init__(self, ncin: int, ncout: int, ncfactor: float = 0.25, kern: int = 3,
                 stride: int = 1, ibn: bool = False, se: bool = False):
        super().__init__()
        if kern % 2 != 1:
            raise ValueError(f"ResNet50BottBlock takes an odd kernel, got {kern}")
        ncmid = int(max(ncin, ncout) * ncfactor)
        ncmid += ncmid % 2
        self.conv1 = nn.Conv2d(ncin, ncmid, 1, bias=False)
        self.norm1 = InstanceBatchNorm(ncmid) if ibn else BatchNorm(ncmid)
        self.conv2 = nn.Conv2d(ncmid, ncmid, kern, stride=stride, padding=kern // 2, bias=False)
        self.norm2 = BatchNorm(ncmid)
        self.conv3 = nn.Conv2d(ncmid, ncout, 1, bias=False)
        self.norm3 = BatchNorm(ncout)
        self.se = SqueezeExcitation2d(ncout) if se else None
        self.shortcut = ncin != ncout or stride != 1
        if self.shortcut:
            self.short_conv = nn.Conv2d(ncin, ncout, kern, stride=stride, padding=kern // 2,
                                        bias=False)
            self.short_norm = BatchNorm(ncout)

    def forward(self, h):
        x = F.relu(self.norm1(self.conv1(h)))
        x = F.relu(self.norm2(self.conv2(x)))
        x = self.norm3(self.conv3(x))
        if self.se is not None:
            x = self.se(x)
        sc = self.short_norm(self.short_conv(h)) if self.shortcut else h
        return F.relu(x + sc)


class MyIBNResBlock(nn.Module):
    """Pre-activation residual block with IBN/SE options and a zero-init
    learnable ``gain`` on the residual branch."""

    def __init__(self, ncin: int, ncout: int, factor: float = 0.5, kern: int = 3,
                 stride: int = 1, ibn: str = "pre", se: str = "none"):
        super().__init__()
        ncmid = max(1, int(max(ncin, ncout) * factor))
        ncmid += ncmid % 2
        self.ibn, self.se = ibn, se
        self.norm1 = InstanceBatchNorm(ncin) if ibn == "pre" else BatchNorm(ncin)
        if se == "pre":
            self.se_pre = SqueezeExcitation2d(ncin)
        self.conv1 = PadConv2d(ncin, ncmid, kern, stride=stride, use_bias=False)
        self.norm2 = InstanceBatchNorm(ncmid) if ibn == "post" else BatchNorm(ncmid)
        self.conv2 = PadConv2d(ncmid, ncout, kern, use_bias=False)
        if se == "post":
            self.se_post = SqueezeExcitation2d(ncout)
        self.skip = ncin != ncout or stride != 1
        if self.skip:
            self.skip_norm = BatchNorm(ncin)
            self.skip_conv = PadConv2d(ncin, ncout, kern, stride=stride, use_bias=False)
        self.gain = nn.Parameter(torch.zeros(1))

    def forward(self, h):
        x = self.norm1(h)
        if self.se == "pre":
            x = self.se_pre(x)
        x = self.conv1(F.relu(x))
        x = self.conv2(F.relu(self.norm2(x)))
        if self.se == "post":
            x = self.se_post(x)
        sc = self.skip_conv(F.relu(self.skip_norm(h))) if self.skip else h
        return self.gain * x + sc
