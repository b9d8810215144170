"""Audio front of the reference: a 16-bit PCM WAV file to 16 kHz mono
chunks of 30 s.

The resampler is the textbook polyphase one: upsample by L, low-pass with a
Kaiser-windowed sinc (24 zero crossings a side, beta 14, gain L, cutoff at
the lower of the two Nyquist rates), downsample by M; output j is
``sum_n x[n] h[n L - j M + half]``, ``ceil(T L / M)`` samples. It runs in
float64 on the given device.
"""

from __future__ import annotations

import math
import wave

import numpy as np

SAMPLE_RATE = 16000
CHUNK = 30 * SAMPLE_RATE


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """(float64 mono samples in [-1, 1), sample rate) of a 16-bit PCM WAV."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: the reference reads 16-bit PCM only")
        sr, ch = w.getframerate(), w.getnchannels()
        x = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float64) / 32768.0
    return x.reshape(-1, ch).mean(axis=1), sr


def lowpass(L: int, M: int, zeros: int = 24, beta: float = 14.0) -> np.ndarray:
    cutoff = 1.0 / max(L, M)
    half = zeros * max(L, M)
    n = np.arange(-half, half + 1, dtype=np.float64)
    return L * cutoff * np.sinc(cutoff * n) * np.kaiser(2 * half + 1, beta)


def resample(x: np.ndarray, sr: int, device, target: int = SAMPLE_RATE, block: int = 1 << 18):
    """float64 tensor of ``x`` resampled from ``sr`` to ``target`` on
    ``device``."""
    import torch

    xt = torch.as_tensor(x, dtype=torch.float64, device=device)
    if sr == target:
        return xt
    g = math.gcd(sr, target)
    L, M = target // g, sr // g
    h = torch.as_tensor(lowpass(L, M), device=device)
    half, T = (len(h) - 1) // 2, len(x)
    K = -(-len(h) // L)
    bank = torch.nn.functional.pad(h, (0, K * L - len(h))).view(K, L).T  # bank[r, m] = h[r + m L]
    out_len = -(-T * L // M)
    pad = K + 1
    xp = torch.nn.functional.pad(xt, (pad, pad))
    out = torch.empty(out_len, dtype=torch.float64, device=device)
    m = torch.arange(K, device=device)
    for lo in range(0, out_len, block):
        j = torch.arange(lo, min(lo + block, out_len), device=device)
        t0 = j * M - half  # the upsampled index of tap 0
        r = (-t0) % L  # the first tap that meets an input sample
        n0 = (t0 + r) // L  # that input sample
        idx = n0[:, None] + m[None, :]
        valid = (idx >= 0) & (idx < T)
        xs = xp[(idx + pad).clamp(0, len(xp) - 1)] * valid
        out[lo:lo + len(j)] = (xs * bank[r]).sum(dim=1)
    return out


def chunks(y) -> "torch.Tensor":
    """(n_chunks, 480000) zero-padded 30 s chunks of a 1-D tensor, at least
    one."""
    import torch

    n = max(1, -(-len(y) // CHUNK))
    out = torch.zeros((n, CHUNK), dtype=y.dtype, device=y.device)
    out.view(-1)[:len(y)] = y
    return out
