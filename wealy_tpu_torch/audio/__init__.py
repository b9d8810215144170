"""Audio frontend: Whisper log-mel (plain PyTorch and the fused kernel K1),
resampling and decoding, re-exported as ``wealy_tpu.audio`` exports them
(K1's wrapper, ``log_mel_spectrogram_fused``, in place of the Pallas one)."""

from wealy_tpu_torch._lazy import lazy_getattr

# bound here, as the JAX package binds it: the function, not its module
from wealy_tpu_torch.audio.resample import resample

_LAZY = {
    "wealy_tpu_torch.audio.mel": (
        "SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_LENGTH", "N_SAMPLES", "N_FRAMES",
        "hann_window", "mel_filterbank", "log_mel_spectrogram", "pad_or_trim",
    ),
    "wealy_tpu_torch.audio.fused_mel": ("log_mel_spectrogram_fused",),
    "wealy_tpu_torch.audio.decode": ("load_audio",),
}
__getattr__ = lazy_getattr(__name__, _LAZY)

__all__ = [
    "SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_LENGTH", "N_SAMPLES", "N_FRAMES", "hann_window",
    "mel_filterbank", "log_mel_spectrogram", "pad_or_trim", "log_mel_spectrogram_fused",
    "load_audio", "resample",
]
