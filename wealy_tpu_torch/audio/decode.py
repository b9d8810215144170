"""Host-side audio decode to 16 kHz mono float32, the counterpart of
``wealy_tpu.audio.decode``.

WAV files (by content first, then by name) go through the native host
decoder (:mod:`wealy_tpu_torch.native`: PCM 8/16/24/32-bit, IEEE float,
extensible WAVs, downmixed to mono) when it is built, else the stdlib
decoder (PCM 8/16/32-bit); mp3 goes through the native ``libmpg123`` path;
other formats, and mp3 without ``libmpg123``, through ffmpeg when a binary
is on PATH. An off-rate file is resampled on the host by
:func:`_host_resample`: the native polyphase resampler with the taps of
:mod:`wealy_tpu_torch.audio.resample`, else that module's torch resampler.
"""

from __future__ import annotations

import math
import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np

from wealy_tpu_torch import native
from wealy_tpu_torch.audio.mel import SAMPLE_RATE
from wealy_tpu_torch.audio.resample import _design_lowpass, resample


def _decode_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a PCM WAV file to (float32 mono waveform, sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # the stdlib module rejects IEEE-float WAVs, so 4 bytes is int32 PCM
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def _decode_ffmpeg(path: str, sr: int) -> np.ndarray:
    cmd = ["ffmpeg", "-nostdin", "-threads", "0", "-i", path, "-f", "s16le", "-ac", "1",
           "-acodec", "pcm_s16le", "-ar", str(sr), "-"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype="<i2").astype(np.float32) / 32768.0


def _host_resample(x: np.ndarray, file_sr: int, sr: int) -> np.ndarray:
    """Resample on the host: the native polyphase resampler with
    :func:`_design_lowpass`'s taps (within 2e-4 of the torch resampler),
    else the torch resampler. On the host, so the decode threads of the
    batched extraction never touch the card."""
    g = math.gcd(file_sr, sr)
    L, M = sr // g, file_sr // g
    if native.available():
        return native.resample_native(x, L, M, _design_lowpass(L, M))
    return resample(x, file_sr, sr).numpy()


def load_audio(path: str | Path, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load a WAV or mp3 file (or, with an ffmpeg binary, another format)
    as float32 mono at ``sr`` Hz."""
    path = str(path)
    head = b""
    if Path(path).is_file():
        with open(path, "rb") as f:
            head = f.read(12)
    # dispatch by content first: corpora carry WAV bytes under .mp3 names
    # (the lyric-covers layout hard-codes the suffix), and mpg123 would grind
    # through them as junk; RIFF alone is not enough (AVI and WebP are RIFF
    # too), so require the WAVE form type
    is_wav_bytes = head[:4] == b"RIFF" and head[8:12] == b"WAVE"
    if is_wav_bytes or path.lower().endswith(".wav"):
        # the native decoder first (24-bit, float and extensible WAVs, which
        # the stdlib module rejects), then the stdlib decoder
        got = native.try_decode_wav_bytes(Path(path).read_bytes()) if native.available() else None
        x, file_sr = got if got is not None else _decode_wav(path)
        return _host_resample(x, file_sr, sr) if file_sr != sr else x
    if path.lower().endswith(".mp3") and native.mp3_available():
        got = native.try_decode_mp3_bytes(Path(path).read_bytes())
        if got is not None:
            x, file_sr = got
            return _host_resample(x, file_sr, sr) if file_sr != sr else x
        # malformed for libmpg123: ffmpeg, where present, gets a try
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"cannot decode {path!r}: unsupported without native mp3 support or an ffmpeg "
            "binary"
        )
    return _decode_ffmpeg(path, sr)
