"""ctypes bindings for the native host data plane (``wealy_host.cpp``), the
counterpart of ``wealy_tpu.native``: WAV decode (PCM 8/16/24/32-bit, IEEE
float, WAVE_FORMAT_EXTENSIBLE, any channel count downmixed to mono),
polyphase resampling, 30 s chunk packing, and mp3 decode through the
system ``libmpg123`` (opened with ``dlopen``).

The library is host code, compiled on first use::

    g++ -O3 -march=native -shared -fPIC -std=c++17 wealy_host.cpp -o libwealy_host.so -ldl

into ``native/_build/<hash>/`` (gitignored), where ``<hash>`` covers the
source, the flags and the host CPU (``-march=native`` code runs only on the
CPU it was built for). The build is
:func:`wealy_tpu_torch._build.build_once`, as for the CUDA kernels: the
compiler writes a name of its own process and the finished file is renamed
into place, so a concurrent process (a test worker, a decode thread) never
loads a partial library. Where no compiler
is present, or it fails, :func:`available` is False (:func:`build_error`
says why) and the callers in :mod:`wealy_tpu_torch.audio.decode` take
their Python paths, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from wealy_tpu_torch._build import build_once, content_key

SRC = Path(__file__).parent / "wealy_host.cpp"
BUILD_ROOT = Path(__file__).parent / "_build"
LIB_NAME = "libwealy_host.so"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None  # set when this process compiled the library

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "wav_info": ([_U8P, _U64, ctypes.POINTER(_U64), ctypes.POINTER(ctypes.c_uint32)],
                 ctypes.c_int),
    "wav_decode": ([_U8P, _U64, _F32P], ctypes.c_int),
    "resample_poly": ([_F32P, _U64, ctypes.c_int, ctypes.c_int, _F32P, ctypes.c_int, _F32P,
                       _U64], ctypes.c_int),
    "pack_chunks": ([_F32P, _U64, _U64, _F32P, _U64], ctypes.c_int),
    "mp3_available": ([], ctypes.c_int),
    "mp3_decode_alloc": ([_U8P, _U64, ctypes.POINTER(_F32P), ctypes.POINTER(_U64),
                          ctypes.POINTER(ctypes.c_uint32)], ctypes.c_int),
    "wealy_free": ([ctypes.c_void_p], None),
}


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), or the empty string where /proc/cpuinfo is absent."""
    cpuinfo = Path("/proc/cpuinfo")
    if not cpuinfo.exists():
        return b""
    lines = cpuinfo.read_text().splitlines()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def library_path(src: Path = SRC) -> Path:
    """Where the library built from ``src`` on this host lives."""
    return BUILD_ROOT / content_key(src.read_bytes(), " ".join(CXX_FLAGS).encode(),
                                    _cpu_identity()) / LIB_NAME


def build(src: Path = SRC) -> tuple[Optional[Path], str]:
    """Compile ``src`` unless this host's build of it exists: (library
    path, "") or (None, why not) where there is no ``g++`` or it fails."""
    global build_seconds

    def compile_to(tmp: Path) -> str:
        if shutil.which("g++") is None:
            return "g++ not found on PATH"
        proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp), "-ldl"],
                              capture_output=True, text=True)
        return f"g++ exit {proc.returncode}: {proc.stderr[-2000:]}" if proc.returncode else ""

    lib_path, why, seconds = build_once(library_path(src), compile_to)
    if seconds is not None:
        build_seconds = seconds
    return lib_path, why


def load(path: Path) -> ctypes.CDLL:
    """Open a built library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            path, why = build()
            if path is None:
                _build_error = why
            else:
                _lib = load(path)
        return _lib


def available() -> bool:
    """True when the library is built and loaded (built on first call)."""
    return _ensure_built() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable, or None."""
    _ensure_built()
    return _build_error


def _require() -> ctypes.CDLL:
    lib = _ensure_built()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def _u8(buf: bytes):
    arr = np.frombuffer(buf, dtype=np.uint8)
    return arr.ctypes.data_as(_U8P), arr


def _f32(x: np.ndarray):
    return x.ctypes.data_as(_F32P)


def _wav(data: bytes) -> tuple[Optional[np.ndarray], int]:
    """(waveform, sample rate), or (None, the library's error code)."""
    lib = _require()
    ptr, keepalive = _u8(data)
    n = _U64()
    sr = ctypes.c_uint32()
    rc = lib.wav_info(ptr, len(data), ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        return None, rc
    out = np.empty(n.value, np.float32)
    rc = lib.wav_decode(ptr, len(data), _f32(out))
    return (out, int(sr.value)) if rc == 0 else (None, rc)


def try_decode_wav_bytes(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """WAV bytes -> (float32 mono waveform, sample_rate), or None where the
    input is malformed or of a format the library does not decode."""
    out, sr = _wav(data)
    return None if out is None else (out, sr)


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes -> (float32 mono waveform, sample_rate); raises
    ``ValueError`` on malformed or unsupported input (the JAX binding's
    contract; :func:`try_decode_wav_bytes` returns None instead)."""
    out, sr = _wav(data)
    if out is None:
        raise ValueError(f"wav decode failed (code {sr})")
    return out, sr


def mp3_available() -> bool:
    """True when libmpg123 is loadable (the native mp3 decode path)."""
    lib = _ensure_built()
    return lib is not None and bool(lib.mp3_available())


def _mp3(data: bytes) -> tuple[Optional[np.ndarray], int]:
    """(waveform, sample rate), or (None, the library's error code)."""
    lib = _require()
    ptr, keepalive = _u8(data)
    out_p = _F32P()
    n = _U64()
    sr = ctypes.c_uint32()
    rc = lib.mp3_decode_alloc(ptr, len(data), ctypes.byref(out_p), ctypes.byref(n),
                              ctypes.byref(sr))
    if rc != 0:
        return None, rc
    out = np.ctypeslib.as_array(out_p, shape=(n.value,)).copy()
    lib.wealy_free(out_p)
    return out, int(sr.value)


def try_decode_mp3_bytes(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """MP3 bytes -> (float32 mono waveform, sample_rate) through libmpg123,
    or None where libmpg123 is unavailable or the input is malformed."""
    out, sr = _mp3(data)
    return None if out is None else (out, sr)


def decode_mp3_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """MP3 bytes -> (float32 mono waveform, sample_rate) through libmpg123;
    raises ``RuntimeError`` where libmpg123 is unavailable and
    ``ValueError`` on malformed input, as the JAX binding does."""
    out, sr = _mp3(data)
    if out is None and sr == 1:
        raise RuntimeError("libmpg123 not available for mp3 decode")
    if out is None:
        raise ValueError(f"mp3_decode_alloc failed (code {sr})")
    return out, sr


def resample_native(x: np.ndarray, L: int, M: int, taps: np.ndarray) -> np.ndarray:
    """Polyphase resampling by L/M with precomputed taps (the taps of
    :func:`wealy_tpu_torch.audio.resample._design_lowpass`)."""
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    taps = np.ascontiguousarray(taps, np.float32)
    out_len = -(-len(x) * L // M)
    out = np.empty(out_len, np.float32)
    rc = lib.resample_poly(_f32(x), len(x), L, M, _f32(taps), len(taps), _f32(out), out_len)
    if rc != 0:
        raise ValueError(f"resample_poly failed (code {rc})")
    return out


def pack_chunks_native(x: np.ndarray, chunk: int) -> np.ndarray:
    """(n,) -> (n_chunks, chunk) zero-padded chunk matrix (at least one)."""
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    n_chunks = max(1, -(-len(x) // chunk))
    out = np.empty((n_chunks, chunk), np.float32)
    rc = lib.pack_chunks(_f32(x), len(x), chunk, _f32(out), n_chunks)
    if rc != 0:
        raise ValueError(f"pack_chunks failed (code {rc})")
    return out
