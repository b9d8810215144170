"""Port of the log-mel frontend (wealy_tpu_torch.audio) against the JAX
package: the same seeded waveforms through wealy_tpu.audio.mel and the
port's plain version and kernel wrapper (K1)."""

import numpy as np
import pytest
import torch

from wealy_tpu.audio import mel as jmel
from wealy_tpu_torch.audio import mel as tmel
from wealy_tpu_torch.audio.fused_mel import ATOL, RTOL, log_mel_spectrogram_fused


@pytest.fixture(scope="module")
def clips():
    """Noise, and noise with a quiet tone and a zero-padded tail (a song's
    last chunk). A loud pure tone is left out: the bins beside it are
    Hann-sidelobe cancellations, where any other f32 summation order
    differs by ~1e-4 relative, so it tests the order, not the port."""
    rng = np.random.default_rng(42)
    t = np.arange(tmel.N_SAMPLES) / tmel.SAMPLE_RATE
    noise = 0.1 * rng.normal(size=tmel.N_SAMPLES)
    mixed = 0.05 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=tmel.N_SAMPLES)
    mixed[300000:] = 0.0
    return np.stack([noise, mixed]).astype(np.float32)


def test_tables_identical_to_jax():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(tmel.mel_filterbank(n_mels), jmel.mel_filterbank(n_mels))
    for a, b in zip(tmel._dft_matrices(), jmel._dft_matrices()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmel.hann_window(), jmel.hann_window())


def test_frame_audio_matches_jax(clips):
    got = tmel.frame_audio(torch.from_numpy(clips)).numpy()
    want = np.asarray(jmel.frame_audio(clips))
    assert got.shape == want.shape == (2, tmel.N_FRAMES, tmel.N_FFT)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(clips, n_mels):
    got = tmel.log_mel_spectrogram(torch.from_numpy(clips), n_mels=n_mels).numpy()
    want = np.asarray(jmel.log_mel_spectrogram(clips, n_mels=n_mels))
    assert got.shape == want.shape == (2, n_mels, tmel.N_FRAMES)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fused_wrapper_on_cpu_is_the_plain_version(clips):
    x = torch.from_numpy(clips)
    np.testing.assert_array_equal(
        log_mel_spectrogram_fused(x).numpy(), tmel.log_mel_spectrogram(x).numpy()
    )
    one = log_mel_spectrogram_fused(x[0])
    assert one.shape == (80, tmel.N_FRAMES)
    np.testing.assert_array_equal(one.numpy(), tmel.log_mel_spectrogram(x)[0].numpy())


def test_wrong_length_raises():
    with pytest.raises(ValueError, match="samples"):
        tmel.log_mel_spectrogram(torch.zeros(1, 1000))


def test_kernel_bases_are_row_major():
    """The kernel reads the bases through raw pointers: they must be
    row-major (the filterbank table itself is a transposed numpy view)."""
    for n_mels in (80, 128):
        wcos, wsin, melw = tmel.bases(n_mels, torch.device("cpu"))
        assert melw.shape == (tmel.N_FREQS, n_mels)
        assert all(t.is_contiguous() for t in (wcos, wsin, melw))
