"""The port's audio front (wealy_tpu_torch.audio.decode, .resample) against
the JAX package's on the CPU: the stdlib WAV decode is exact, and the
polyphase resampler stays within 2e-4 of the JAX one, the bound the JAX
package holds its native resampler to."""

import wave

import numpy as np
import pytest

from wealy_tpu.audio.decode import _decode_wav as j_decode_wav
from wealy_tpu.audio.resample import resample as j_resample
from wealy_tpu_torch import native
from wealy_tpu_torch.audio import decode as tdecode
from wealy_tpu_torch.audio.resample import resample

from test_torch_native import jnative  # noqa: F401  (the JAX native library, built race-free)

RESAMPLE_ATOL = 2e-4  # wealy_tpu/audio/decode.py:68-69


def _write(path, data: np.ndarray, sr: int, width: int, channels: int):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def _pcm(rng, n, width, channels):
    if width == 1:
        return rng.integers(0, 256, size=n * channels, dtype=np.uint8)
    dtype = {2: "<i2", 4: "<i4"}[width]
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n * channels, dtype=np.int64).astype(dtype)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_wav_decode_is_exact(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    path = tmp_path / "a.wav"
    _write(path, _pcm(rng, 4000, width, channels), 16000, width, channels)
    got, sr = tdecode._decode_wav(str(path))
    want, jsr = j_decode_wav(str(path))
    assert sr == jsr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # at the target rate load_audio returns the decoded samples as they are
    np.testing.assert_array_equal(tdecode.load_audio(path), want)


@pytest.mark.parametrize("orig_sr", [44100, 22050])
def test_resample_matches_jax(orig_sr):
    rng = np.random.default_rng(orig_sr)
    x = (0.3 * rng.normal(size=(2, orig_sr + 1234))).astype(np.float32)
    got = resample(x, orig_sr, 16000).numpy()
    want = np.asarray(j_resample(x, orig_sr, 16000))
    assert got.shape == want.shape == (2, -(-(orig_sr + 1234) * 16000 // orig_sr))
    np.testing.assert_allclose(got, want, atol=RESAMPLE_ATOL, rtol=0)


def test_resample_shapes_and_identity():
    x = np.linspace(-1, 1, 999, dtype=np.float32)
    np.testing.assert_array_equal(resample(x, 16000, 16000).numpy(), x)
    # upsampling: as many samples as the JAX convolution gives
    assert resample(x, 16000, 44100).shape == np.asarray(j_resample(x, 16000, 44100)).shape
    assert resample(x[:3], 16000, 8000).shape == (2,)


def test_load_audio_resamples_and_dispatches_by_content(tmp_path):
    rng = np.random.default_rng(7)
    pcm = _pcm(rng, 22050, 2, 2)
    misnamed = tmp_path / "song_audio.mp3"  # WAV bytes under an mp3 name
    _write(misnamed, pcm, 22050, 2, 2)
    got = tdecode.load_audio(misnamed)
    x, sr = j_decode_wav(str(misnamed))
    want = np.asarray(j_resample(x, sr, 16000))
    assert got.shape == want.shape == (16000,)
    np.testing.assert_allclose(got, want, atol=RESAMPLE_ATOL, rtol=0)


def _junk_mp3(path):
    path.write_bytes(b"ID3\x03\x00" + bytes(64))


def _unknown_format(path):
    path.write_bytes(b"OggS" + bytes(64))


@pytest.mark.parametrize("name,write", [("real.mp3", _junk_mp3), ("clip.ogg", _unknown_format)])
def test_what_the_port_does_not_decode_raises(tmp_path, monkeypatch, name, write):
    """What the JAX package cannot decode without an ffmpeg binary (a file
    libmpg123 rejects, a format with no decoder of its own) raises the same
    way in the port."""
    from wealy_tpu.audio.decode import load_audio as j_load

    path = tmp_path / name
    write(path)
    monkeypatch.setattr(tdecode.shutil, "which", lambda binary: None)
    monkeypatch.setattr("wealy_tpu.audio.decode.shutil.which", lambda binary: None)
    with pytest.raises(RuntimeError, match="cannot decode"):
        tdecode.load_audio(path)
    with pytest.raises(RuntimeError, match="cannot decode"):
        j_load(path)


def _wav24(path, rng):
    pcm = rng.integers(-(2 ** 23), 2 ** 23, size=2 * 4410)
    u = (pcm & 0xFFFFFF).astype("<u4")
    raw = np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF], 1).astype(np.uint8)
    _write(path, raw, 44100, 3, 2)


def _mp3(path, rng):
    from test_torch_native import _lame, encode_mp3

    if not native.mp3_available() or _lame() is None:
        pytest.skip("libmpg123/libmp3lame not available")
    t = np.arange(22050) / 22050
    path.write_bytes(encode_mp3((0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), 22050))


@pytest.mark.parametrize("name,write", [("deep.wav", _wav24), ("deep_audio.mp3", _wav24),
                                        ("real.mp3", _mp3)])
def test_what_the_port_now_decodes(jnative, tmp_path, name, write):
    """24-bit WAVs (under either name) and mp3 go through the native
    library: the samples the JAX package's load_audio gives, resampled to
    16 kHz, bit for bit."""
    from wealy_tpu.audio.decode import load_audio as j_load

    path = tmp_path / name
    write(path, np.random.default_rng(5))
    got = tdecode.load_audio(path)
    want = j_load(path)
    assert got.dtype == np.float32 and got.shape == want.shape and len(got) > 1000
    np.testing.assert_array_equal(got, want)
