"""The port's native host data plane (wealy_tpu_torch.native) against the JAX
package's (wealy_tpu.native) on the same seeded inputs: WAV decode of every
format the library reads, polyphase resampling and chunk packing bit-equal,
mp3 decode equal under the JAX test's own condition (libmpg123 and
libmp3lame present), the resampler within 2e-4 of the port's torch one, and
the build: atomic under concurrent builds, and absent without g++ (the
Python paths then answer, as in the JAX package)."""

import ctypes
import ctypes.util
import io
import math
import struct
import threading
import wave

import numpy as np
import pytest

from wealy_tpu_torch import native as tnative
from wealy_tpu_torch.audio import decode as tdecode
from wealy_tpu_torch.audio.resample import _design_lowpass, resample
from wealy_tpu_torch.models.whisper.extract import chunk_waveform

RESAMPLE_ATOL = 2e-4  # tests/test_native.py:86, the JAX package's bound

pytestmark = pytest.mark.skipif(not tnative.available(),
                                reason="g++ not available to build the native library")


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    """The JAX package's native module, its library built into a directory
    of this test's own: the package builds in place, which a concurrent
    test process could be doing at the same time."""
    from wealy_tpu import native as jn

    if jn._lib is None:
        saved = jn._LIB
        jn._LIB = tmp_path_factory.mktemp("jax_native") / "libwealy_host.so"
        jn._build_error = None
        ok = jn.available()
        jn._LIB = saved
        assert ok, jn._build_error
    return jn


def _riff(fmt: bytes, payload: bytes) -> bytes:
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)


def wav_bytes(rng, n: int, sr: int, channels: int, kind: str) -> bytes:
    """A WAV of ``n`` frames of seeded noise: ``kind`` is pcm8/16/24/32,
    float32/64, or ext16 / extfloat (WAVE_FORMAT_EXTENSIBLE)."""
    x = np.clip(0.4 * rng.normal(size=n * channels), -1, 1)
    if kind.startswith("pcm") or kind == "ext16":
        bits = 16 if kind == "ext16" else int(kind[3:])
        scale = 2.0 ** (bits - 1) - 1
        ints = np.round(x * scale).astype(np.int64)
        if bits == 8:
            payload = (ints + 128).astype(np.uint8).tobytes()
        elif bits == 24:
            u = (ints & 0xFFFFFF).astype("<u4")
            payload = np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF], 1).astype(
                np.uint8).tobytes()
        else:
            payload = ints.astype({16: "<i2", 32: "<i4"}[bits]).tobytes()
        tag = 1
    else:
        bits = 64 if kind == "float64" else 32
        payload = x.astype("<f8" if bits == 64 else "<f4").tobytes()
        tag = 3
    block = channels * bits // 8
    base = struct.pack("<HHIIHH", tag, channels, sr, sr * block, block, bits)
    if kind.startswith("ext"):
        # cbSize, valid bits, channel mask, then the sub-format GUID whose
        # first two bytes are the real format tag
        guid = struct.pack("<H", tag) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt = struct.pack("<HHIIHH", 0xFFFE, channels, sr, sr * block, block, bits) + struct.pack(
            "<HHI", 22, bits, 0) + guid
    else:
        fmt = base
    return _riff(fmt, payload)


KINDS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64", "ext16", "extfloat"]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_wav_decode_bit_equal_to_jax(jnative, kind, channels):
    rng = np.random.default_rng(KINDS.index(kind) * 10 + channels)
    data = wav_bytes(rng, 3001, 22050, channels, kind)
    got, sr = tnative.try_decode_wav_bytes(data)
    want, jsr = jnative.decode_wav_bytes(data)
    assert sr == jsr == 22050 and got.dtype == np.float32 and got.shape == (3001,)
    np.testing.assert_array_equal(got, want)
    raising, rsr = tnative.decode_wav_bytes(data)
    assert rsr == jsr
    np.testing.assert_array_equal(raising, want)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode_equals_the_stdlib_decoder(jnative, tmp_path, width, channels):
    """Where the stdlib module reads the file, the native decoder gives its
    samples bit for bit (so a host without g++ extracts the same arrays)."""
    from wealy_tpu.audio.decode import _decode_wav as j_decode_wav

    rng = np.random.default_rng(width * 7 + channels)
    path = tmp_path / "a.wav"
    data = wav_bytes(rng, 2000, 16000, channels, f"pcm{8 * width}")
    path.write_bytes(data)
    want, _ = j_decode_wav(str(path))
    np.testing.assert_array_equal(tnative.try_decode_wav_bytes(data)[0], want)
    np.testing.assert_array_equal(tdecode._decode_wav(str(path))[0], want)


@pytest.mark.parametrize("data", [b"not a wav file at all", b"RIFF\x00\x00\x00\x00WAVE",
                                  b"RIFF\x24\x00\x00\x00WAVEfmt \x10\x00\x00\x00" + bytes(16)])
def test_malformed_wav_raises_in_both(jnative, data):
    """The JAX binding raises; the port's reports None, and its callers
    fall through to the stdlib decoder as the JAX package's do."""
    with pytest.raises(ValueError):
        jnative.decode_wav_bytes(data)
    with pytest.raises(ValueError):
        tnative.decode_wav_bytes(data)
    assert tnative.try_decode_wav_bytes(data) is None


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (48000, 16000), (22050, 16000),
                                          (8000, 16000), (16000, 16000)])
def test_resample_bit_equal_to_jax_and_near_torch(jnative, sr_in, sr_out):
    from wealy_tpu.audio.resample import _design_lowpass as j_design

    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    taps = _design_lowpass(L, M)
    np.testing.assert_array_equal(taps, j_design(L, M))
    x = (0.3 * np.random.default_rng(sr_in).normal(size=sr_in // 2 + 77)).astype(np.float32)
    got = tnative.resample_native(x, L, M, taps)
    np.testing.assert_array_equal(got, jnative.resample_native(x, L, M, taps))
    want = resample(x, sr_in, sr_out).numpy()
    n = min(len(got), len(want))  # upsampling: the torch resampler stops a sample early
    assert len(got) - n <= 2
    np.testing.assert_allclose(got[:n], want[:n], atol=RESAMPLE_ATOL, rtol=0)


@pytest.mark.parametrize("n", [0, 1, 4, 10, 479999, 480000, 480001, 1_000_000])
def test_pack_chunks_equal_to_chunk_waveform(jnative, n):
    from wealy_tpu.models.whisper.extract import chunk_waveform as j_chunk

    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = tnative.pack_chunks_native(x, 480000)
    np.testing.assert_array_equal(got, chunk_waveform(x))
    np.testing.assert_array_equal(got, jnative.pack_chunks_native(x, 480000))
    np.testing.assert_array_equal(got, j_chunk(x))


@pytest.mark.parametrize("kind,sr,channels", [("pcm24", 44100, 2), ("float32", 48000, 1),
                                              ("pcm16", 16000, 1), ("ext16", 22050, 2),
                                              ("pcm8", 8000, 1)])
def test_load_audio_bit_equal_to_jax(jnative, tmp_path, kind, sr, channels):
    """Decode and resample to 16 kHz through both packages' load_audio:
    WAV bytes under the lyric-covers layout's .mp3 name, dispatched by
    content."""
    from wealy_tpu.audio.decode import load_audio as j_load

    path = tmp_path / "v_audio.mp3"
    path.write_bytes(wav_bytes(np.random.default_rng(sr), sr // 3, sr, channels, kind))
    got = tdecode.load_audio(path)
    want = j_load(path)
    assert got.dtype == np.float32 and got.shape == want.shape == (-(-(sr // 3) * 16000 // sr),)
    np.testing.assert_array_equal(got, want)


# --- mp3, under the JAX test's own condition (tests/test_native_mp3.py:81) -------------------

def _lame():
    for name in ("libmp3lame.so.0", "libmp3lame.so", ctypes.util.find_library("mp3lame")):
        if not name:
            continue
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def encode_mp3(x: np.ndarray, sr: int, right: np.ndarray = None) -> bytes:
    """Float PCM -> mp3 bytes at 192 kbps with the system libmp3lame (the
    fixture encoder of tests/test_native_mp3.py; the port never encodes)."""
    lame = _lame()
    lame.lame_init.restype = ctypes.c_void_p
    gfp = ctypes.c_void_p(lame.lame_init())
    lame.lame_set_in_samplerate(gfp, ctypes.c_int(sr))
    lame.lame_set_num_channels(gfp, ctypes.c_int(2 if right is not None else 1))
    lame.lame_set_brate(gfp, ctypes.c_int(192))
    assert lame.lame_init_params(gfp) >= 0
    x = np.ascontiguousarray(x, np.float32)
    r = np.ascontiguousarray(right if right is not None else x, np.float32)
    buf = ctypes.create_string_buffer(int(1.25 * len(x)) + 7200)
    f32p = ctypes.POINTER(ctypes.c_float)
    m = lame.lame_encode_buffer_ieee_float(gfp, x.ctypes.data_as(f32p), r.ctypes.data_as(f32p),
                                           ctypes.c_int(len(x)), buf, ctypes.c_int(len(buf)))
    assert m >= 0
    tail = ctypes.create_string_buffer(7200)
    t = lame.lame_encode_flush(gfp, tail, ctypes.c_int(len(tail)))
    lame.lame_close(gfp)
    return buf.raw[:m] + tail.raw[:t]


@pytest.fixture
def mp3_ok():
    if not tnative.mp3_available() or _lame() is None:
        pytest.skip("libmpg123/libmp3lame not available")


@pytest.mark.parametrize("sr,stereo", [(44100, False), (32000, True), (16000, False),
                                       (48000, True)])
def test_mp3_decode_equal_to_jax(jnative, mp3_ok, tmp_path, sr, stereo):
    from wealy_tpu.audio.decode import load_audio as j_load

    t = np.arange(sr) / sr
    left = (0.5 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
    right = (0.1 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32) if stereo else None
    data = encode_mp3(left, sr, right)
    got, got_sr = tnative.try_decode_mp3_bytes(data)
    want, want_sr = jnative.decode_mp3_bytes(data)
    assert got_sr == want_sr == sr
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnative.decode_mp3_bytes(data)[0], want)
    amp = float(np.abs(got).max())
    assert (0.25 < amp < 0.35) if stereo else (0.45 < amp < 0.55)
    path = tmp_path / "song.mp3"
    path.write_bytes(data)
    np.testing.assert_array_equal(tdecode.load_audio(path), j_load(path))


def test_malformed_mp3_raises_and_load_audio_falls_through(jnative, mp3_ok, tmp_path,
                                                           monkeypatch):
    junk = b"ID3\x03\x00" + bytes(64) + b"not an mpeg stream" * 50
    with pytest.raises(ValueError):
        jnative.decode_mp3_bytes(junk)
    with pytest.raises(ValueError):
        tnative.decode_mp3_bytes(junk)
    assert tnative.try_decode_mp3_bytes(junk) is None
    path = tmp_path / "junk.mp3"
    path.write_bytes(junk)
    monkeypatch.setattr(tdecode.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="cannot decode"):
        tdecode.load_audio(path)


# --- the build ------------------------------------------------------------------------------

def test_concurrent_builds_are_atomic(tmp_path, monkeypatch):
    """Four threads build one fresh source at once: every one loads a whole
    library and no temporary file is left."""
    src = tmp_path / "wealy_host.cpp"
    src.write_bytes(tnative.SRC.read_bytes())
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "_build")
    results, errors = [], []

    def one():
        path, why = tnative.build(src)
        errors.append(why)
        results.append(tnative.load(path).mp3_available() in (0, 1))

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [True] * 4 and errors == [""] * 4
    lib = tnative.library_path(src)
    assert lib.parent.parent == tmp_path / "_build" and lib.exists()
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]


def test_without_a_compiler_the_python_paths_answer(tmp_path, monkeypatch):
    """No g++ and no library built: ``available()`` is False with the reason,
    WAVs decode through the stdlib module, a 24-bit WAV raises as in the
    JAX package's Python path, and off-rate audio resamples in torch."""
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.available() and "g++ not found" in tnative.build_error()
    assert not tnative.mp3_available()
    rng = np.random.default_rng(3)
    wav = tmp_path / "a.wav"
    wav.write_bytes(wav_bytes(rng, 4410, 44100, 2, "pcm16"))
    x, sr = tdecode._decode_wav(str(wav))
    np.testing.assert_array_equal(tdecode.load_audio(wav), resample(x, sr, 16000).numpy())
    deep = tmp_path / "deep.wav"
    deep.write_bytes(wav_bytes(rng, 100, 16000, 1, "pcm24"))
    with pytest.raises((ValueError, EOFError)):
        tdecode.load_audio(deep)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        tnative.try_decode_wav_bytes(wav.read_bytes())


def test_wav_bytes_fixture_reads_back_in_the_stdlib_module():
    """The hand-written RIFF writer above agrees with the stdlib module
    where that module reads the format."""
    data = wav_bytes(np.random.default_rng(0), 50, 16000, 2, "pcm16")
    with wave.open(io.BytesIO(data)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()) == (
            2, 2, 16000, 50)
