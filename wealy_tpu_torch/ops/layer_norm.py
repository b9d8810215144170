"""Row-wise LayerNorm over the last axis: kernel K6 (``csrc/layer_norm.cu``),
replacing the TPU kernel ``wealy_tpu/ops/layer_norm.py:26`` ``_ln_kernel``
(public ``fused_layer_norm``).

:func:`fused_layer_norm` is a ``torch.autograd.Function``: its forward takes
the plain version :func:`_reference_ln` for a CPU tensor and launches the
kernel for a CUDA tensor (bf16 or f32 ``x``, f32 ``scale`` and ``bias`` of
shape (D,)), raising on anything else; its backward is autograd of
:func:`_reference_ln` on the saved inputs, as the JAX ``custom_vjp``'s
``_bwd`` (``layer_norm.py:82-85``): the JAX package has no backward kernel,
so neither has the port. The kernel takes any row count; the TPU wrapper's
padding of rows to ``ROW_BLOCK`` has no counterpart.

What bounds it on an H100: device memory. It reads each row once and
writes it once (at (64, 1500, 384) bf16, 147 MB, about 44 us at 3.35
TB/s) and does about 8 operations per element. The design keeps a row in
registers (one warp per row, 16-byte loads) for both statistics passes and
the affine transform, so nothing but x and the output crosses device
memory.
"""

from __future__ import annotations

import torch

from wealy_tpu_torch import _build

# tests/test_layer_norm.py's bounds against the plain version
F32_TOL = 1e-5  # rtol and atol, f32 input (:18)
BF16_TOL = 2e-2  # rtol and atol, bf16 output (:29)
MAX_D = 2048  # kMaxD in csrc/layer_norm.cu


def _reference_ln(x, scale, bias, eps: float):
    """f32 mean and biased variance over the last axis, rsqrt(var + eps),
    the affine transform in f32, the result in x's dtype
    (``layer_norm.py:36-41``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _kernel_route(t: torch.Tensor) -> bool:
    """The wrapper launches the kernel unless the tensor lies on the CPU."""
    return t.device.type != "cpu"


def _launch_ln(x, scale, bias, eps: float):
    """K6 on (..., D) CUDA x."""
    D = x.shape[-1]
    if (
        x.device.type != "cuda"
        or {scale.device, bias.device} != {x.device}
        or x.dtype not in (torch.bfloat16, torch.float32)
        or {scale.dtype, bias.dtype} != {torch.float32}
        or scale.shape != (D,)
        or bias.shape != (D,)
        or not 1 <= D <= MAX_D
    ):
        raise ValueError(
            "fused_layer_norm: the kernel takes bf16 or f32 CUDA x (..., D) with "
            f"1 <= D <= {MAX_D} and f32 scale, bias (D,) on the same device; got x "
            f"{tuple(x.shape)} {x.dtype} {x.device}, scale {tuple(scale.shape)} {scale.dtype} "
            f"{scale.device}, bias {tuple(bias.shape)} {bias.dtype} {bias.device}"
        )
    xr = x.reshape(-1, D).contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(xr)
    if xr.shape[0]:
        _build.check(
            _build.library().wealy_layer_norm(
                xr.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                xr.shape[0], D, int(x.dtype == torch.bfloat16), float(eps),
                _build.stream(x.device),
            ),
            "fused_layer_norm",
        )
        fused_layer_norm.launches += 1
    return out.reshape(x.shape)


def _ln_fwd(x, scale, bias, eps: float = 1e-5):
    """The forward alone: K6, or the plain version for a CPU tensor."""
    if not _kernel_route(x):
        return _reference_ln(x, scale, bias, eps)
    return _launch_ln(x, scale, bias, eps)


class _FusedLayerNorm(torch.autograd.Function):
    """K6 forward; backward = autograd of _reference_ln on the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _ln_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = _reference_ln(*leaves, ctx.eps)
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], g))
        return (*(next(grads) if n else None for n in need), None)


def fused_layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis: f32 statistics, output in x's dtype;
    differentiable in x, scale and bias."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return _FusedLayerNorm.apply(x, scale, bias, eps)
    return _ln_fwd(x, scale, bias, eps)


fused_layer_norm.launches = 0
