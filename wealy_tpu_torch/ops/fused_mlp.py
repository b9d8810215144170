"""Transformer MLP gelu(x @ W1 + b1) @ W2 + b2: kernel K3
(``csrc/fused_mlp.cu``), the counterpart of ``wealy_tpu.ops.fused_mlp``
(a ``jax.custom_vjp``).

Weights are in torch's nn.Linear layout: ``w1`` (4D, D), ``w2`` (D, 4D);
the JAX function takes their transposes. :func:`fused_mlp` is a
``torch.autograd.Function`` when a gradient is needed: its forward is K3
and its backward is autograd of :func:`_reference_mlp` recomputed from the
saved inputs, the JAX package's own policy (no backward kernel). Under
``torch.no_grad()`` it runs the forward alone. The forward takes the plain
version :func:`_reference_mlp` for a CPU tensor and launches the kernel for
a CUDA tensor (bf16 x/w, f32 biases, D and 4D multiples of 64, any row
count), raising on anything else.

What bounds it on an H100: the tensor cores (two GEMMs of N x D x 4D MACs).
The kernel runs each GEMM on wgmma in 128 x 128 tiles fed by a TMA ring,
with the bias and GELU in the first product's epilogue and the bf16 hidden
state through device memory between the two (``csrc/fused_mlp.cu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wealy_tpu_torch import _build


def _reference_mlp(x, w1, b1, w2, b2):
    """bf16 operands, f32 accumulation, f32 biases and GELU, hidden rounded
    to the input dtype before the second product (fused_mlp.py:56-59)."""
    h = x.float() @ w1.float().T + b1.float()
    h = F.gelu(h, approximate="none").to(x.dtype)
    return (h.float() @ w2.float().T + b2.float()).to(x.dtype)


def _kernel_route(t: torch.Tensor) -> bool:
    """The wrapper launches the kernel unless the tensor lies on the CPU."""
    return t.device.type != "cpu"


def _launch_mlp(x, w1, b1, w2, b2):
    """K3 on (..., D) bf16 CUDA x."""
    D = x.shape[-1]
    Dff = w1.shape[0]
    if (
        x.device.type != "cuda"
        or {w1.device, b1.device, w2.device, b2.device} != {x.device}
        or {x.dtype, w1.dtype, w2.dtype} != {torch.bfloat16}
        or {b1.dtype, b2.dtype} != {torch.float32}
        or w1.shape != (Dff, D)
        or w2.shape != (D, Dff)
        or b1.shape != (Dff,)
        or b2.shape != (D,)
        or D % 64
        or Dff % 64
    ):
        raise ValueError(
            "fused_mlp: the kernel takes bf16 CUDA x (..., D), w1 (Dff, D), w2 (D, Dff) "
            f"and f32 biases, D and Dff multiples of 64; got x {tuple(x.shape)} {x.dtype} "
            f"{x.device}, w1 {tuple(w1.shape)} {w1.dtype}, b1 {b1.dtype}, "
            f"w2 {tuple(w2.shape)} {w2.dtype}, b2 {b2.dtype}"
        )
    shape = x.shape
    xr = x.reshape(-1, D).contiguous()
    if xr.data_ptr() % 16:  # TMA reads 16-byte aligned bases: a view off the grid is copied
        xr = xr.clone()
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    N = xr.shape[0]
    hidden = torch.empty((N, Dff), dtype=x.dtype, device=x.device)
    out = torch.empty((N, D), dtype=x.dtype, device=x.device)
    _build.check(
        _build.library().wealy_fused_mlp(
            xr.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            hidden.data_ptr(), out.data_ptr(), N, D, Dff, _build.stream(x.device),
        ),
        "fused_mlp",
    )
    fused_mlp.launches += 1
    return out.reshape(shape)


def fused_mlp_fwd(x, w1, b1, w2, b2):
    """The forward alone: K3, or the plain version for a CPU tensor."""
    if not _kernel_route(x):
        return _reference_mlp(x, w1, b1, w2, b2)
    return _launch_mlp(x, w1, b1, w2, b2)


class _FusedMLP(torch.autograd.Function):
    """K3 forward; backward = autograd of _reference_mlp on the saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return fused_mlp_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = _reference_mlp(*leaves)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if n else None for n in need)


def fused_mlp(x, w1, b1, w2, b2):
    """(..., D) -> (..., D); differentiable in every argument."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w1, b1, w2, b2)
    ):
        return _FusedMLP.apply(x, w1, b1, w2, b2)
    return fused_mlp_fwd(x, w1, b1, w2, b2)


fused_mlp.launches = 0
