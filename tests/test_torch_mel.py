"""Port of the log-mel frontend (wealy_tpu_torch.audio) against the JAX
package: the same seeded waveforms through wealy_tpu.audio.mel and the
port's plain version and kernel wrapper (K1); and K1's tables: its FFT
plan, run in torch, against the dense DFT basis, and its banded mel table
against the filterbank."""

import numpy as np
import pytest
import torch

from wealy_tpu.audio import mel as jmel
from wealy_tpu_torch.audio import mel as tmel
from wealy_tpu_torch.audio import fused_mel
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


def _dft(n: int) -> np.ndarray:
    """The forward n-point DFT matrix, float64."""
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n)


def _fft_power(frames: torch.Tensor) -> torch.Tensor:
    """The power |X|^2 of the windowed 400-point real DFT of ``frames``
    (..., 400) -> (..., 201), by K1's plan from fused_mel.fft_plan's tables,
    as log_mel.cu runs it: z[n] = w x[2n] + i w x[2n+1]; a radix-8 stage
    over n1 (n = 25 n1 + n2), times W200^(n2 k1); 5-point DFTs over a
    (n2 = 5a + b), times W25^(b c); 5-point DFTs over b, giving
    Z[k1 + 8 (c + 5 d)]; then the real split. In complex128 when ``frames``
    is float64, else complex64."""
    n1, n2, r5, n_fft = fused_mel.N1, fused_mel.N2, fused_mel.R5, tmel.N_FFT
    cdt = torch.complex128 if frames.dtype == torch.float64 else torch.complex64
    plan = torch.from_numpy(fused_mel.fft_plan())
    win, rest = plan[:n_fft].to(frames.dtype), plan[n_fft:]
    tw200 = torch.view_as_complex(rest[: 2 * n2 * n1].reshape(n2, n1, 2).contiguous()).to(cdt)
    rest = rest[2 * n2 * n1:]
    tw25 = torch.view_as_complex(rest[: 2 * r5 * r5].reshape(r5, r5, 2).contiguous()).to(cdt)
    split = torch.view_as_complex(rest[2 * r5 * r5:].reshape(-1, 2).contiguous()).to(cdt)
    w8, w5 = (torch.from_numpy(_dft(n)).to(cdt) for n in (n1, r5))

    x = frames * win
    z = torch.complex(x[..., 0::2], x[..., 1::2]).to(cdt)  # (..., 200)
    y = z.reshape(*z.shape[:-1], n1, n2)  # [n1][n2]
    y = torch.einsum("kn,...nj->...kj", w8, y) * tw200.T  # [k1][n2]
    y = y.reshape(*y.shape[:-1], r5, r5)  # [k1][a][b]
    u = torch.einsum("ca,...kab->...kbc", w5, y) * tw25  # [k1][b][c]
    zz = torch.einsum("db,...kbc->...kcd", w5, u)  # Z[k1 + 8 (c + 5 d)] at [k1][c][d]
    big_z = zz.transpose(-3, -1).reshape(*zz.shape[:-3], n1 * n2)  # [d][c][k1] -> k
    half = n_fft // 2
    k = torch.arange(half // 2 + 1)
    zk, zc = big_z[..., k], big_z[..., (half - k) % half].conj()
    a, b = (zk + zc) / 2, (zk - zc) / 2j
    t = b * split
    lo, hi = (a + t).abs().square(), (a - t).abs().square()
    return torch.cat([lo, hi[..., :-1].flip(-1)], dim=-1)  # bins 0..100, then 101..200


def test_fft_plan_reproduces_the_dense_dft_power():
    """K1's plan (window, W200, W25 and W400 tables rounded to f32, the
    8 x 5 x 5 stages and the real split), run in torch on random frames,
    gives the power of the dense windowed DFT basis of the plain version:
    in float64 within 1e-5 of each bin (only the tables' f32 rounding
    differs), and in f32, as the kernel runs it, within 1e-5 of each
    frame's largest bin (the dense f32 product itself is 6e-5 off per bin)."""
    rng = np.random.default_rng(5)
    frames = rng.normal(size=(64, tmel.N_FFT))
    wcos, wsin = (torch.from_numpy(a).double() for a in tmel._dft_matrices())
    x = torch.from_numpy(frames)
    want = (x @ wcos).square() + (x @ wsin).square()
    got = _fft_power(x)
    assert got.shape == (64, tmel.N_FREQS)
    assert ((got - want).abs() / want).max() <= 1e-5
    got32 = _fft_power(x.float()).double()
    assert ((got32 - want).abs().amax(-1) / want.amax(-1)).max() <= 1e-5


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bands_reproduce_the_filterbank(n_mels):
    """K1 reads each slaney band as (first bin, count, weights): scattered
    back, the table is mel_filterbank exactly, and every band is one
    contiguous run of nonzeros."""
    band, weights = fused_mel.mel_bands(n_mels)
    fb = tmel.mel_filterbank(n_mels)
    dense = np.zeros_like(fb)
    for m, (first, count) in enumerate(band):
        dense[first:first + count, m] = weights[m, :count]
        assert (weights[m, :count] != 0).all() and (weights[m, count:] == 0).all()
    np.testing.assert_array_equal(dense, fb)
    assert band[:, 1].max() <= fused_mel.BAND_WIDTH
    assert fused_mel.fft_plan().shape == (1052,)  # the layout log_mel.cu asserts
