"""Constant-Q transform frontends of the CLEWS acoustic branch, the
counterpart of ``wealy_tpu.audio.cqt``.

- :func:`cqt_spectrogram`: pseudo-CQT, a constant-Q triangular filterbank
  on STFT magnitudes (framing, one windowed-DFT product pair, one
  (n_freqs, n_bins) product).
- :func:`cqt_multirate`: the true constant-Q transform, octave by octave:
  the top octave's complex kernels on the full-rate signal, and every lower
  octave on the signal halved once more (kaiser polyphase decimation,
  :func:`wealy_tpu_torch.audio.resample.resample`) with the same kernel
  matrix, since the kernels depend only on f / sr.
- :func:`direct_cqt_reference`: the textbook per-bin full-rate transform in
  numpy, the ground truth of the multirate one.

Defaults: 16 kHz input, fmin = C1 (32.70 Hz), 7 octaves x 12 bins = 84
bins. The transforms take a numpy array or a tensor, (T,) or (B, T), and
return a float32 tensor on the input's device (the CPU for an array), or on
``device`` when given.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from wealy_tpu_torch.audio.mel import SAMPLE_RATE, hann_window


@functools.lru_cache(maxsize=None)
def cqt_filterbank(
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float = 32.703194,  # C1
    sr: int = SAMPLE_RATE,
    n_fft: int = 2048,
) -> np.ndarray:
    """Triangular constant-Q filterbank: (n_fft//2 + 1, n_bins).

    Bin k has center frequency fmin * 2**(k / bins_per_octave); triangles span
    the geometric neighbors, normalized to unit area (slaney-style) so energy
    is comparable across octaves.
    """
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    centers = fmin * 2.0 ** (np.arange(-1, n_bins + 1) / bins_per_octave)
    fb = np.zeros((n_bins, n_freqs), np.float64)
    for b in range(n_bins):
        lo, c, hi = centers[b], centers[b + 1], centers[b + 2]
        rise = (fft_freqs - lo) / max(c - lo, 1e-9)
        fall = (hi - fft_freqs) / max(hi - c, 1e-9)
        tri = np.maximum(0.0, np.minimum(rise, fall))
        if tri.sum() == 0.0:
            # low bins can be narrower than one FFT bin: fall back to the
            # nearest frequency bin so every CQT bin has support
            tri[np.argmin(np.abs(fft_freqs - c))] = 1.0
        fb[b] = tri * (2.0 / max(hi - lo, 1e-9))
    return fb.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cqt_dft(n_fft: int):
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    f = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * t * f / n_fft
    win = hann_window(n_fft)[:, None]
    return (
        (win * np.cos(ang)).astype(np.float32),
        (win * np.sin(ang)).astype(np.float32),
    )


def _batch(audio, device):
    x = torch.as_tensor(audio, dtype=torch.float32)
    if device is not None:
        x = x.to(device)
    squeeze = x.ndim == 1
    return (x[None] if squeeze else x), squeeze


def _frames(x: torch.Tensor, half: int, width: int, hop: int, n_frames: int) -> torch.Tensor:
    """Reflect-pad ``half`` samples each side, then ``n_frames`` frames of
    ``width`` samples every ``hop``: (B, n_frames, width)."""
    xp = F.pad(x[:, None], (half, half), mode="reflect")[:, 0]
    return xp.unfold(-1, width, hop)[:, :n_frames]


def cqt_spectrogram(
    audio,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float = 32.703194,
    sr: int = SAMPLE_RATE,
    n_fft: int = 2048,
    hop: int = 512,
    device=None,
) -> torch.Tensor:
    """(B, T) waveform -> (B, n_bins, n_frames) CQT magnitude.

    Feed through :class:`wealy_tpu_torch.models.layers.CQTPrepare`
    (power/normalize) into the CLEWS encoder as (B, 1, n_bins, n_frames).
    """
    x, squeeze = _batch(audio, device)
    half = n_fft // 2
    n_frames = 1 + x.shape[1] // hop  # 1 + (T + 2 * half - n_fft) // hop
    frames = _frames(x, half, n_fft, hop, n_frames)  # (B, n_frames, n_fft)
    wcos, wsin = (torch.from_numpy(w).to(x.device) for w in _cqt_dft(n_fft))
    re = frames @ wcos
    im = frames @ wsin
    mag = torch.sqrt(re * re + im * im + 1e-12)  # (B, n_frames, n_freqs)
    fb = torch.from_numpy(cqt_filterbank(n_bins, bins_per_octave, fmin, sr, n_fft)).to(x.device)
    out = (mag @ fb).transpose(1, 2)  # (B, n_bins, n_frames)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# True (multirate) CQT
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=None)
def _top_octave_kernels(bins_per_octave: int, f_top: float, sr: int) -> tuple:
    """Complex CQT kernels for ONE octave [f_top, 2*f_top) at rate ``sr``.

    Bin j (j in [0, bpo)) has center f_j = f_top * 2**(j/bpo), window length
    N_j = round(Q * sr / f_j) with Q = 1/(2**(1/bpo) - 1), hann-windowed
    complex exponential centered in a common frame of length L (padded to a
    multiple of 8). Kernels are L1-of-window normalized so a unit sinusoid
    at f_j measures magnitude ~1 in that bin. Returns (wcos (L, bpo), wsin
    (L, bpo), L).
    """
    Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lengths = [
        max(4, int(round(Q * sr / (f_top * 2.0 ** (j / bins_per_octave)))))
        for j in range(bins_per_octave)
    ]
    L = _round_up(max(lengths), 8)
    wcos = np.zeros((L, bins_per_octave), np.float64)
    wsin = np.zeros((L, bins_per_octave), np.float64)
    for j, N in enumerate(lengths):
        f = f_top * 2.0 ** (j / bins_per_octave)
        n = np.arange(N) - (N - 1) / 2.0
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N) / max(N - 1, 1))
        ang = 2.0 * np.pi * f * n / sr
        start = (L - N) // 2  # center inside the common frame
        norm = 2.0 / win.sum()
        wcos[start : start + N, j] = win * np.cos(ang) * norm
        wsin[start : start + N, j] = win * np.sin(ang) * norm
    return wcos.astype(np.float32), wsin.astype(np.float32), L


def cqt_multirate(
    audio,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float = 32.703194,
    sr: int = SAMPLE_RATE,
    hop: int = 512,
    device=None,
) -> torch.Tensor:
    """True constant-Q transform: (B, T) waveform -> (B, n_bins, n_frames).

    Frames at octave o are taken at stride hop/2**o of the o-times-decimated
    signal, so all octaves share one frame grid: ``hop`` must be divisible
    by 2**(n_octaves-1) (512 for the default 7 octaves). Accuracy against
    the direct full-rate transform is bounded by the decimation filter:
    about 1% on the lowest octaves.
    """
    from wealy_tpu_torch.audio.resample import resample

    if n_bins % bins_per_octave:
        raise ValueError(f"n_bins {n_bins} is not a whole number of octaves of {bins_per_octave}")
    n_oct = n_bins // bins_per_octave
    if hop % (2 ** (n_oct - 1)):
        raise ValueError(f"hop {hop} must be divisible by 2**{n_oct - 1} for a shared frame grid")
    x, squeeze = _batch(audio, device)
    n_frames = 1 + x.shape[1] // hop

    f_top = fmin * 2.0 ** ((n_oct - 1) * 1.0)  # lowest bin of the TOP octave
    wcos, wsin, L = _top_octave_kernels(bins_per_octave, float(f_top), sr)
    wc = torch.from_numpy(wcos).to(x.device)
    ws = torch.from_numpy(wsin).to(x.device)

    octaves = []  # top first
    for o in range(n_oct):
        hop_o = hop >> o
        half = L // 2
        if x.shape[1] <= half:
            # deep octaves of short clips: reflect padding needs dim > width;
            # extend with silence
            x = F.pad(x, (0, half + 1 - x.shape[1]))
        frames = _frames(x, half, L, hop_o, n_frames)  # (B, n_frames, L)
        if frames.shape[1] < n_frames:
            # the JAX gather clamps frames past the end to the last sample
            xp = F.pad(x[:, None], (half, half), mode="reflect")[:, 0]
            idx = (torch.arange(n_frames, device=x.device)[:, None] * hop_o
                   + torch.arange(L, device=x.device)[None, :]).clamp(max=xp.shape[1] - 1)
            frames = xp[:, idx]
        re = frames @ wc
        im = frames @ ws
        octaves.append(torch.sqrt(re * re + im * im + 1e-12))  # (B, n_frames, bpo)
        if o != n_oct - 1:
            x = resample(x, 2, 1)  # anti-aliased halving; kernels reused as-is
    # octave o holds bins [n_bins-(o+1)*bpo, n_bins-o*bpo)
    out = torch.cat(list(reversed(octaves)), dim=-1).transpose(1, 2)  # (B, n_bins, n_frames)
    return out[0] if squeeze else out


def direct_cqt_reference(
    audio: np.ndarray,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float = 32.703194,
    sr: int = SAMPLE_RATE,
    hop: int = 512,
) -> np.ndarray:
    """Textbook per-bin full-rate CQT (numpy, O(n_bins * T * N_k)), the
    ground truth of :func:`cqt_multirate`: the same windowing, centering and
    normalization, no decimation."""
    x = np.asarray(audio, np.float64)
    if x.ndim != 1:
        raise ValueError(f"direct_cqt_reference takes one (T,) waveform, got {x.shape}")
    n_frames = 1 + len(x) // hop
    Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    out = np.zeros((n_bins, n_frames), np.float64)
    for k in range(n_bins):
        f = fmin * 2.0 ** (k / bins_per_octave)
        N = max(4, int(round(Q * sr / f)))
        n = np.arange(N) - (N - 1) / 2.0
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N) / max(N - 1, 1))
        norm = 2.0 / win.sum()
        ker = win * np.exp(-2j * np.pi * f * n / sr) * norm
        half = N // 2
        xp = np.pad(x, (half, half + N), mode="reflect")
        for t in range(n_frames):
            s = t * hop  # kernel sample m multiplies x[s - N//2 + m]
            out[k, t] = np.abs(np.dot(xp[s : s + N], ker))
    return out.astype(np.float32)
