"""The port's CQT frontends (wealy_tpu_torch.audio.cqt) against the JAX
package's on the CPU, from the same numpy audio: the filterbank and the
kernels equal, ``cqt_spectrogram`` and ``cqt_multirate`` at rtol 1e-4 /
atol 1e-5 (the log-mel's gate), and the multirate transform against the
direct per-bin reference within the JAX test's bounds
(tests/test_cqt_tokenizer_utils.py::TestMultirateCQT)."""

import numpy as np
import pytest
import torch

from wealy_tpu.audio import cqt as jcqt
from wealy_tpu_torch.audio import cqt as tcqt

RTOL, ATOL = 1e-4, 1e-5
FMIN = 32.703194


def _audio(seconds: float, seed: int = 0, batch: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    tones = sum(a * np.sin(2 * np.pi * FMIN * 2 ** (k / 12) * t)
                for a, k in ((0.5, 9), (0.3, 45), (0.2, 70)))
    shape = (batch, len(t)) if batch else (len(t),)
    return (tones + 0.05 * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"n_bins": 48, "bins_per_octave": 12, "n_fft": 1024}])
def test_filterbank_and_dft_equal(kw):
    np.testing.assert_array_equal(tcqt.cqt_filterbank(**kw), jcqt.cqt_filterbank(**kw))
    for a, b in zip(tcqt._cqt_dft(kw.get("n_fft", 2048)), jcqt._cqt_dft(kw.get("n_fft", 2048))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcqt._top_octave_kernels(12, FMIN * 64, 16000),
                    jcqt._top_octave_kernels(12, FMIN * 64, 16000)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", ["1d", "batch"])
@pytest.mark.parametrize("hop", [512, 256])
def test_cqt_spectrogram_matches_jax(shape, hop):
    x = _audio(1.3, seed=1, batch=0 if shape == "1d" else 3)
    want = np.asarray(jcqt.cqt_spectrogram(x, hop=hop))
    got = tcqt.cqt_spectrogram(x, hop=hop)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # a tensor input gives the same
    np.testing.assert_array_equal(tcqt.cqt_spectrogram(torch.from_numpy(x), hop=hop).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("seconds", [1.0, 0.2])
def test_cqt_multirate_matches_jax(seconds):
    """Including a clip short enough that the deepest octaves pad with
    silence before their reflect padding."""
    x = _audio(seconds, seed=2, batch=2)
    want = np.asarray(jcqt.cqt_multirate(x))
    got = tcqt.cqt_multirate(x)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_multirate_matches_direct_reference():
    """The JAX test's bounds against the direct transform, and the port's
    ``direct_cqt_reference`` equal to the JAX one."""
    sr, hop = 16000, 512
    t = np.arange(sr) / sr
    f1, f2, f3 = (FMIN * 2 ** (k / 12) for k in (6, 42, 78))
    x = (0.7 * np.sin(2 * np.pi * f1 * t) + 0.5 * np.sin(2 * np.pi * f2 * t)
         + 0.3 * np.sin(2 * np.pi * f3 * t)).astype(np.float32)
    want = tcqt.direct_cqt_reference(x, hop=hop)
    np.testing.assert_array_equal(want, jcqt.direct_cqt_reference(x, hop=hop))
    got = tcqt.cqt_multirate(x, hop=hop).numpy()
    assert got.shape == want.shape == (84, 32)
    g, w = got[:, 4:-4], want[:, 4:-4]  # interior frames
    denom = float(np.max(np.abs(w)))
    assert np.max(np.abs(g - w)) / denom < 0.08
    for o in range(1, 7):
        sl = slice(o * 12, (o + 1) * 12)
        assert np.max(np.abs(g[sl] - w[sl])) / denom < 0.02, o


def test_tone_lands_in_its_bin_and_bad_arguments_raise():
    t = np.arange(16000 * 2) / 16000
    x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)  # A4: bin 45
    assert abs(int(tcqt.cqt_spectrogram(x).mean(dim=1).argmax()) - 45) <= 1
    with pytest.raises(ValueError, match="octaves"):
        tcqt.cqt_multirate(x, n_bins=80)
    with pytest.raises(ValueError, match="divisible"):
        tcqt.cqt_multirate(x, hop=500)
    with pytest.raises(ValueError):
        tcqt.direct_cqt_reference(np.zeros((2, 100), np.float32))
