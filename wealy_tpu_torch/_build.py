"""Build-on-first-use for the hand-written CUDA kernels (``csrc/*.cu``).

The first call to :func:`library` compiles each ``csrc/*.cu`` into an
object file, one ``nvcc`` per source, all started together::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu

then links them into one shared library with a plain C interface
(``nvcc -shared -o libwealy_kernels.so *.o``) in ``csrc/_build/<hash>/``,
where ``<hash>`` covers the sources and the flags, and loads it with
``ctypes``. Pointers and the CUDA stream cross the
boundary as ``c_void_p``; every entry point returns ``cudaGetLastError()``
after its launch and :func:`check` raises when that is not 0. A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).parent / "csrc"
BUILD_ROOT = CSRC / "_build"
LIB_NAME = "libwealy_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in build.log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes (all return int = cudaError_t)
SIGNATURES = {
    # audio, plan, band, band_w, out, batch, n_samples, n_frames, n_mels, band_width, stream
    "wealy_log_mel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, lse (or null), batch, tq, tk, heads, head_dim, scale, stream
    "wealy_flash_mha_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, g, lse, delta, dq, batch, tq, tk, heads, head_dim, scale, stream
    "wealy_flash_mha_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, g, lse, delta, dk, dv, batch, tq, tk, heads, head_dim, scale, stream
    "wealy_flash_mha_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # x, w1, b1, w2, b2, hidden, out, rows, d_model, d_ff, stream
    "wealy_fused_mlp": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # d, qvalid, cvalid, out, Q, B, s1, s2, stride_q, stride_b, stride_s1, stride_s2,
    # n_rounds, eps, inf, stream
    "wealy_bpwr_redux": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _F, _F, _P],
    # s1, s2 -> K4's route (0 sorted, 1/2 block: tile in shared/device memory)
    "wealy_bpwr_route": [_I, _I],
    # x, scale, bias, out, rows, D, is_bf16, eps, route, vec, lanes, per_lane, stream
    "wealy_layer_norm": [_P, _P, _P, _P, _L, _I, _I, _F, _I, _I, _I, _I, _P],
    # x, y, scale, bias, s, out, rows, D, is_bf16, eps, route, vec, lanes, per_lane, stream
    "wealy_add_layer_norm": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _I, _I, _I, _I, _P],
    # q, k, v, pos (or null), out, batch_heads, tk, head_dim, kv_kind, scale, stream
    "wealy_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the nvcc run in this process (None: cached)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def content_key(*parts: bytes) -> str:
    """A 16-hex-digit key of ``parts`` (sources, flags, host): the name of
    a build directory, so that a change to any part builds anew."""
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return h.hexdigest()[:16]


def _source_hash() -> str:
    return content_key(" ".join(NVCC_FLAGS).encode(),
                       *(p.name.encode() + p.read_bytes() for p in sources()))


def build_once(lib_path: Path, make: Callable[[Path], str]
               ) -> tuple[Optional[Path], str, Optional[float]]:
    """Build the shared library ``lib_path`` unless it exists. ``make(tmp)``
    writes it under a name of this process and thread and returns "" or
    why it failed; the finished file is then renamed into place, so a
    concurrent process or thread never loads a partial library. Returns
    (``lib_path``, "", seconds of ``make`` or None where the library was
    already there) or (None, why, None)."""
    if lib_path.exists():
        return lib_path, "", None
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    why = make(tmp)
    if why:
        tmp.unlink(missing_ok=True)
        return None, why, None
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees a partial file
    return lib_path, "", time.perf_counter() - t0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built"
    )


def _compile_and_link(tmp: Path) -> str:
    """One ``nvcc`` per source, all started together, then the link into
    ``tmp``; the log goes to ``build.log`` beside it. Returns "" or the
    failures."""
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{src.stem}.{tmp.name}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, obj, proc in jobs:
        output = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + output)
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[-1]).name} (exit {proc.returncode}):\n{output[-3000:]}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stderr[-3000:]}")
    (tmp.parent / "build.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    return "\n".join(failed)


def build() -> Path:
    """Compile the kernels unless a build of the current sources exists;
    returns the library path."""
    global build_seconds
    lib_path, why, seconds = build_once(BUILD_ROOT / _source_hash() / LIB_NAME,
                                        _compile_and_link)
    if lib_path is None:
        raise RuntimeError("nvcc failed: " + why)
    if seconds is not None:
        build_seconds = seconds
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.wealy_error_string.argtypes = [ctypes.c_int]
            lib.wealy_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().wealy_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream(device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device``: kernels launch
    there and do not synchronise."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
