"""Fused log-mel kernel K1 (``csrc/log_mel.cu``), the counterpart of
``wealy_tpu.audio.pallas_mel``.

:func:`log_mel_spectrogram_fused` takes the plain version
(:func:`wealy_tpu_torch.audio.mel.log_mel_spectrogram`) for a CPU tensor and
launches the kernel for a CUDA tensor. The kernel does framing (reflect
pad), the windowed real DFT as an FFT, power, the mel product over each
band's nonzeros and log10; the per-clip max-8 clamp and (x+4)/4 stay in
PyTorch, as they stay outside the Pallas kernel.

The kernel's tables are built here in float64 and rounded to f32:
:func:`fft_plan` (window and twiddles of its 8 x 25-point FFT and real
split) and :func:`mel_bands` (each slaney band's first bin, bin count and
weights). The CPU tests run the same plan in torch and hold it against the
dense DFT basis of the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from wealy_tpu_torch import _build
from wealy_tpu_torch.audio.mel import (
    N_FFT,
    N_FRAMES,
    N_SAMPLES,
    finish_log_mel,
    hann_window,
    log_mel_spectrogram,
    mel_filterbank,
)

# How close K1 must come to its plain version: f32 throughout, only the
# summation order differs (the golden tolerance of the JAX package's fused
# mel against its plain path)
RTOL, ATOL = 1e-4, 1e-5
# the 200-point complex FFT of the even/odd-packed frame: 8 x 25, and 25 as 5 x 5
N1, N2, R5 = 8, 25, 5
BAND_WIDTH = 16  # bins per mel band in the kernel's table (slaney bands span at most 14)


def _interleave(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], -1).ravel()


@functools.lru_cache(maxsize=None)
def fft_plan() -> np.ndarray:
    """K1's plan, f32: the periodic Hann window (400), W200^(n2 k1) as
    [n2][k1] (25 x 8 complex), W25^(b c) as [b][c] (5 x 5 complex), and
    W400^k for k = 0..100 (the real split), complex values as (re, im)."""
    n2, k1 = np.arange(N2)[:, None], np.arange(N1)[None, :]
    b, c = np.arange(R5)[:, None], np.arange(R5)[None, :]
    half = N_FFT // 2
    plan = np.concatenate([
        hann_window(N_FFT),
        _interleave(np.exp(-2j * np.pi * n2 * k1 / half)),
        _interleave(np.exp(-2j * np.pi * b * c / N2)),
        _interleave(np.exp(-2j * np.pi * np.arange(half // 2 + 1) / N_FFT)),
    ])
    return plan.astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_bands(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The slaney filterbank as K1 reads it: (n_mels, 2) int32 (first bin,
    bin count) and (n_mels, BAND_WIDTH) f32 weights, zero past the count.
    Each band's nonzeros are one contiguous bin range."""
    fb = mel_filterbank(n_mels)  # (n_freqs, n_mels)
    band = np.zeros((n_mels, 2), np.int32)
    weights = np.zeros((n_mels, BAND_WIDTH), np.float32)
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        first, count = int(nz[0]), int(nz[-1] - nz[0] + 1)
        if count > BAND_WIDTH:
            raise ValueError(f"mel band {m} spans {count} bins > {BAND_WIDTH}")
        band[m] = first, count
        weights[m, :count] = fb[first:first + count, m]
    return band, weights


@functools.lru_cache(maxsize=None)
def kernel_tables(n_mels: int, device: torch.device):
    """(plan, band, band weights) tensors on ``device``, built once per device."""
    band, weights = mel_bands(n_mels)
    return tuple(torch.from_numpy(a).to(device) for a in (fft_plan(), band, weights))


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
    plan, band, band_w = kernel_tables(n_mels, audio.device)
    log_spec = torch.empty((B, n_mels, N_FRAMES), dtype=torch.float32, device=audio.device)
    _build.check(
        _build.library().wealy_log_mel(
            audio.data_ptr(), plan.data_ptr(), band.data_ptr(), band_w.data_ptr(),
            log_spec.data_ptr(), B, N_SAMPLES, N_FRAMES, n_mels, BAND_WIDTH,
            _build.stream(audio.device),
        ),
        "log_mel_spectrogram_fused",
    )
    log_mel_spectrogram_fused.launches += 1
    out = finish_log_mel(log_spec)
    return out[0] if squeeze else out


log_mel_spectrogram_fused.launches = 0
