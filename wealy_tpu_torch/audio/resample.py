"""Polyphase sample-rate conversion, the counterpart of
``wealy_tpu.audio.resample`` (same kaiser-windowed sinc taps).

The JAX package writes upsample-by-L, filter and downsample-by-M as one
dilated convolution. Here the same sum runs phase by phase, without the
L-times upsampled signal: output ``j`` is ``sum_n x[n] * taps[n*L - j*M +
half]``, and the outputs ``j0, j0 + L, j0 + 2L, ...`` use one sub-filter
``taps[r::L]`` on the input with stride M, so each of the L phases is one
strided dot product (``unfold`` then a matrix-vector product).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _design_lowpass(L: int, M: int, zeros: int = 24, beta: float = 14.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for L/M resampling, gain L.

    Cutoff at min(1/L, 1/M) of the upsampled Nyquist; ``zeros`` sinc
    zero-crossings per side (filter length ~ 2*zeros*max(L,M))."""
    cutoff = min(1.0 / L, 1.0 / M)
    half = int(zeros * max(L, M))
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = cutoff * np.sinc(cutoff * n)
    taps *= np.kaiser(2 * half + 1, beta)
    taps *= L  # compensate the zero-insertion energy loss
    return taps.astype(np.float32)


def resample(audio, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Resample the last axis from ``orig_sr`` to ``target_sr``.

    audio: (..., T) float array or tensor. Returns a float32 tensor (...,
    ceil(T * target_sr / orig_sr)) (upsampling: as many samples as the JAX
    function gives) on the input's device (the CPU for an array)."""
    x = torch.as_tensor(audio, dtype=torch.float32)
    if orig_sr == target_sr:
        return x
    g = math.gcd(orig_sr, target_sr)
    L, M = target_sr // g, orig_sr // g
    taps = torch.from_numpy(_design_lowpass(L, M)).to(x.device)
    k = taps.shape[0]
    half = (k - 1) // 2
    shape, T = x.shape, x.shape[-1]
    x = x.reshape(-1, T)
    # ceil(T * L / M), but no more than the JAX convolution's own output
    # length, which is shorter by a sample or two when upsampling
    out_len = min(-(-T * L // M), (T - 1) * L // M + 2)
    K = -(-k // L)  # taps per phase
    bank = F.pad(taps, (0, K * L - k)).reshape(K, L).T  # bank[r, m] = taps[r + m*L]
    # per phase j0: the first tap r, the first input sample n0 (may be < 0),
    # and the number of outputs j0, j0 + L, ... below out_len
    phases = []
    for j0 in range(min(L, out_len)):
        r = (half - j0 * M) % L
        n0 = (j0 * M - half + r) // L
        phases.append((j0, r, n0, len(range(j0, out_len, L))))
    pad_l = max(0, -min(n0 for _, _, n0, _ in phases))
    pad_r = max(0, max(n0 + (nq - 1) * M + K - T for _, _, n0, nq in phases))
    xp = F.pad(x, (pad_l, pad_r))
    y = x.new_empty((x.shape[0], out_len))
    for j0, r, n0, nq in phases:
        seg = xp[:, pad_l + n0 : pad_l + n0 + (nq - 1) * M + K]
        y[:, j0::L] = seg.unfold(-1, K, M) @ bank[r]
    return y.reshape(*shape[:-1], out_len)
