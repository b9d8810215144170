"""Whisper log-mel spectrogram in plain PyTorch (counterpart of
``wealy_tpu.audio.mel``).

The numpy tables (periodic Hann window, slaney mel filterbank, windowed
real-DFT basis) are the JAX package's, unchanged. :func:`log_mel_spectrogram`
is the plain version of the fused CUDA kernel in
:mod:`wealy_tpu_torch.audio.fused_mel`: centred framing with reflect pad,
frames @ cos/sin basis, power, @ mel filterbank, log10 clamp at 1e-10,
per-clip max-8 clamp and (x+4)/4. All of it is f32; on the card it must run
with TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``, the
PyTorch default) to meet the golden tolerance.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000: samples per 30 s chunk
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000: mel frames per 30 s chunk
N_FREQS = N_FFT // 2 + 1  # 201


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


def _hz_to_mel_slaney(f):
    """Slaney mel scale (librosa htk=False): linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    mel = f * 3.0 / 200.0
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    f = m * 200.0 / 3.0
    above = m >= min_log_mel
    f = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
    return f


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    n_mels: int = 80, n_fft: int = N_FFT, sr: int = SAMPLE_RATE
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_fft//2+1, n_mels).

    Matches librosa.filters.mel(htk=False, norm="slaney") — the filterbank
    Whisper ships precomputed.
    """
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(0.0), _hz_to_mel_slaney(sr / 2.0), n_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)  # (n_mels + 2,)

    fdiff = np.diff(hz_pts)  # (n_mels + 1,)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # (n_mels + 2, n_freqs)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_freqs)

    # Slaney normalization: each filter integrates to ~constant energy.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb = fb * enorm[:, None]
    return fb.T.astype(np.float32)  # (n_freqs, n_mels)


@functools.lru_cache(maxsize=None)
def _dft_matrices(n_fft: int = N_FFT):
    """Windowed real-DFT basis: (n_fft, n_freqs) cos/sin with the Hann window
    folded in, so STFT = frames @ cos - 1j * frames @ sin."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    f = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * t * f / n_fft
    win = hann_window(n_fft)[:, None]
    wcos = (win * np.cos(ang)).astype(np.float32)
    wsin = (win * np.sin(ang)).astype(np.float32)
    return wcos, wsin


@functools.lru_cache(maxsize=None)
def bases(n_mels: int, device: torch.device):
    """(wcos, wsin, melw) row-major f32 tensors on ``device`` (built once per
    device; the filterbank table is a transposed, column-major numpy view)."""
    wcos, wsin = _dft_matrices()
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (wcos, wsin, mel_filterbank(n_mels))
    )


def frame_audio(audio: torch.Tensor) -> torch.Tensor:
    """(B, N_SAMPLES) -> (B, N_FRAMES, N_FFT) centred frames with reflect pad:
    frame f spans samples [160 f - 200, 160 f + 200) of the clip."""
    half = N_FFT // 2
    x = F.pad(audio[:, None], (half, half), mode="reflect")[:, 0]  # (B, 480400)
    return x.unfold(-1, N_FFT, HOP_LENGTH)[:, :N_FRAMES]


def finish_log_mel(log_spec: torch.Tensor) -> torch.Tensor:
    """Per-clip dynamic-range clamp (global max - 8) and (x+4)/4 scaling of a
    (B, n_mels, N_FRAMES) log10-mel."""
    mx = log_spec.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(log_spec, mx - 8.0) + 4.0) / 4.0


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Whisper log-mel: (B, N_SAMPLES) or (N_SAMPLES,) f32 waveform ->
    (B, n_mels, N_FRAMES) f32 (or (n_mels, N_FRAMES))."""
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    if audio.shape[-1] != N_SAMPLES:
        raise ValueError(
            f"expected {N_SAMPLES} samples (chunk the audio first), got {audio.shape[-1]}"
        )
    wcos, wsin, melw = bases(n_mels, audio.device)
    frames = frame_audio(audio.float())  # (B, 3000, 400)
    re = frames @ wcos  # (B, 3000, 201)
    im = frames @ wsin
    mel = (re * re + im * im) @ melw  # (B, 3000, n_mels)
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10)).transpose(1, 2)
    out = finish_log_mel(log_spec)
    return out[0] if squeeze else out
