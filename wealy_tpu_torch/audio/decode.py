"""Host-side audio decode to 16 kHz mono float32, the counterpart of
``wealy_tpu.audio.decode``.

WAV files (by content or by name) go through the stdlib decoder (PCM 8, 16
and 32-bit); other formats through ffmpeg when a binary is on PATH. An
off-rate file is resampled on the host (:mod:`wealy_tpu_torch.audio.resample`,
the JAX package's filter). The JAX package's native C++ decoder (24-bit,
float and extensible WAVs) and its native mp3 decoder are not ported yet:
those files raise here rather than decode differently.
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np

from wealy_tpu_torch.audio.mel import SAMPLE_RATE
from wealy_tpu_torch.audio.resample import resample


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
        raise ValueError(
            f"unsupported WAV sample width: {width} bytes (24-bit WAVs need the native "
            "decoder, not ported yet)"
        )
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def _decode_ffmpeg(path: str, sr: int) -> np.ndarray:
    cmd = ["ffmpeg", "-nostdin", "-threads", "0", "-i", path, "-f", "s16le", "-ac", "1",
           "-acodec", "pcm_s16le", "-ar", str(sr), "-"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype="<i2").astype(np.float32) / 32768.0


def load_audio(path: str | Path, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load a WAV file (or, with an ffmpeg binary, another format except
    mp3) as float32 mono at ``sr`` Hz."""
    path = str(path)
    with open(path, "rb") as f:
        head = f.read(12)
    # dispatch by content first: corpora carry WAV bytes under .mp3 names
    # (the lyric-covers layout hard-codes the suffix); RIFF alone is not
    # enough (AVI and WebP are RIFF too), so require the WAVE form type
    is_wav_bytes = head[:4] == b"RIFF" and head[8:12] == b"WAVE"
    if is_wav_bytes or path.lower().endswith(".wav"):
        x, file_sr = _decode_wav(path)
        # resampled on the host, as the JAX package does (decode.py:67-74)
        return resample(x, file_sr, sr).numpy() if file_sr != sr else x
    if path.lower().endswith(".mp3"):
        raise NotImplementedError(
            f"cannot decode {path!r}: mp3 needs the native decoder, not ported yet "
            "(ROADMAP item 3)"
        )
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(f"cannot decode {path!r}: not a WAV file and no ffmpeg binary")
    return _decode_ffmpeg(path, sr)
