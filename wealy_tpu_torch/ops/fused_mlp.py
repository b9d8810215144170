"""Transformer MLP gelu(x @ W1 + b1) @ W2 + b2: kernel K3
(``csrc/fused_mlp.cu``), the counterpart of ``wealy_tpu.ops.fused_mlp``
(forward only).

Weights are in torch's nn.Linear layout: ``w1`` (4D, D), ``w2`` (D, 4D);
the JAX function takes their transposes. :func:`fused_mlp` takes the plain
version :func:`_reference_mlp` for a CPU tensor and launches the kernel for
a CUDA tensor (bf16 x/w, f32 biases, D and 4D multiples of 64), raising on
anything else.
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


def fused_mlp(x, w1, b1, w2, b2):
    """(..., D) -> (..., D)."""
    if x.device.type == "cpu":
        return _reference_mlp(x, w1, b1, w2, b2)
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
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    N = xr.shape[0]
    hidden = torch.empty((N, Dff), dtype=x.dtype, device=x.device)
    out = torch.empty((N, D), dtype=x.dtype, device=x.device)
    lib = _build.library()
    _build.check(
        lib.wealy_fused_mlp(
            xr.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            hidden.data_ptr(), out.data_ptr(), N, D, Dff, _build.stream(x.device),
        ),
        "fused_mlp",
    )
    fused_mlp.launches += 1
    return out.reshape(shape)


fused_mlp.launches = 0
