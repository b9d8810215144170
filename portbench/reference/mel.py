"""Whisper's log-mel spectrogram: a centred STFT (periodic Hann window of
400 samples, hop 160, reflect padding), the power of its 201 bins, the last
frame dropped (3000 frames a chunk), a Slaney mel filterbank, log10 clamped
at 1e-10, the per-chunk maximum less 8 as a floor, then (x + 4) / 4.
Computed in float64."""

from __future__ import annotations

import numpy as np

N_FFT, HOP, SR = 400, 160, 16000


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    lin = f * 3.0 / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    lin = m * 200.0 / 3.0
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), lin)


def filterbank(n_mels: int) -> np.ndarray:
    """(201, n_mels) Slaney-normalised triangular filters (librosa's
    ``filters.mel(htk=False, norm="slaney")``)."""
    freqs = np.linspace(0.0, SR / 2.0, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2.0), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    fb = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]).T


def log_mel(chunks, n_mels: int):
    """(B, 480000) float64 tensor -> (B, n_mels, 3000) float64."""
    import torch

    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=chunks.device)
    spec = torch.stft(chunks, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.abs() ** 2
    fb = torch.as_tensor(filterbank(n_mels), device=chunks.device)
    mel = torch.einsum("bft,fm->bmt", power, fb)
    log_spec = torch.log10(mel.clamp(min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0
