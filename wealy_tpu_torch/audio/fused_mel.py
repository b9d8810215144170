"""Fused log-mel kernel K1 (``csrc/log_mel.cu``), the counterpart of
``wealy_tpu.audio.pallas_mel``.

:func:`log_mel_spectrogram_fused` takes the plain version
(:func:`wealy_tpu_torch.audio.mel.log_mel_spectrogram`) for a CPU tensor and
launches the kernel for a CUDA tensor. The kernel does framing (reflect
pad), windowed DFT, power, mel projection and log10; the per-clip max-8
clamp and (x+4)/4 stay in PyTorch, as they stay outside the Pallas kernel.
"""

from __future__ import annotations

import torch

from wealy_tpu_torch import _build
from wealy_tpu_torch.audio.mel import (
    N_FRAMES,
    N_SAMPLES,
    bases,
    finish_log_mel,
    log_mel_spectrogram,
)

# How close K1 must come to its plain version: f32 throughout, only the
# summation order differs (the golden tolerance of the JAX package's fused
# mel against its plain path)
RTOL, ATOL = 1e-4, 1e-5


def log_mel_spectrogram_fused(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, N_SAMPLES) or (N_SAMPLES,) f32 waveform -> (B, n_mels, N_FRAMES) f32."""
    if audio.device.type == "cpu":
        return log_mel_spectrogram(audio, n_mels=n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel_spectrogram_fused: unsupported device {audio.device}")
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    if audio.ndim != 2 or audio.shape[-1] != N_SAMPLES or audio.dtype != torch.float32:
        raise ValueError(
            f"log_mel_spectrogram_fused: want (B, {N_SAMPLES}) float32, "
            f"got {tuple(audio.shape)} {audio.dtype}"
        )
    audio = audio.contiguous()
    B = audio.shape[0]
    wcos, wsin, melw = bases(n_mels, audio.device)
    log_spec = torch.empty((B, n_mels, N_FRAMES), dtype=torch.float32, device=audio.device)
    lib = _build.library()
    _build.check(
        lib.wealy_log_mel(
            audio.data_ptr(), wcos.data_ptr(), wsin.data_ptr(), melw.data_ptr(),
            log_spec.data_ptr(), B, N_SAMPLES, N_FRAMES, n_mels,
            _build.stream(audio.device),
        ),
        "log_mel_spectrogram_fused",
    )
    log_mel_spectrogram_fused.launches += 1
    out = finish_log_mel(log_spec)
    return out[0] if squeeze else out


log_mel_spectrogram_fused.launches = 0
