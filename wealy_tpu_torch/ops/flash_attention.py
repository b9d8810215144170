"""Non-causal multi-head attention for the Whisper encoder: kernel K2
(``csrc/flash_attention.cu``), the counterpart of
``wealy_tpu.ops.flash_attention.flash_mha`` (forward only).

:func:`flash_mha` takes the plain version :func:`_reference_mha` for a CPU
tensor and launches the kernel for a CUDA tensor; the kernel takes bf16 with
head dim 64 (every published Whisper size) and the wrapper raises on
anything else.
"""

from __future__ import annotations

import torch

from wealy_tpu_torch import _build

HEAD_DIM = 64


def _reference_mha(q, k, v, scale: float):
    """f32 scores, f32 softmax, weights cast to the input dtype, f32 PV."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    w = torch.softmax(s * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)


def flash_mha(q, k, v, scale: float):
    """q (B, Tq, H, Dh), k/v (B, Tk, H, Dh) -> (B, Tq, H, Dh).

    ``scale`` multiplies the raw q.k logits (pass Dh**-0.5).
    """
    if q.device.type == "cpu":
        return _reference_mha(q, k, v, scale)
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    if (
        q.device.type != "cuda"
        or {k.device, v.device} != {q.device}
        or {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}
        or Dh != HEAD_DIM
        or k.shape != (B, Tk, H, Dh)
        or v.shape != k.shape
    ):
        raise ValueError(
            "flash_mha: the kernel takes bf16 CUDA q/k/v of shape (B, T, H, 64); got "
            f"q {tuple(q.shape)} {q.dtype} {q.device}, k {tuple(k.shape)} {k.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}"
        )
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _build.library()
    _build.check(
        lib.wealy_flash_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Tq, Tk, H, Dh, float(scale), _build.stream(q.device),
        ),
        "flash_mha",
    )
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
