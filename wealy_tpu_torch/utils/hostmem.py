"""Host-heap discipline for streaming loops (glibc malloc), the port's copy
of ``wealy_tpu.utils.hostmem``.

Streaming loops (``index`` over a split, the evaluate groups) allocate
multi-MB transient host buffers per song group interleaved with small
long-lived appends. glibc raises its mmap threshold after the first multi-MB
free, so later big transients come from the sbrk heap, and the small
long-lived blocks between them fragment it: the free space can be neither
reused whole nor returned, and the resident set climbs group after group.
:func:`pin_malloc_thresholds` keeps the static threshold, so big transients
stay mmap-backed and go back to the OS on free; :func:`trim_host_heap`
returns free heap pages (``malloc_trim(0)``) for loops that want a hard
bound. Every function is a no-op returning False off glibc.
"""

from __future__ import annotations

import ctypes
import platform

# glibc mallopt parameter numbers (bits/malloc.h)
M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3

_libc = None
_pinned = False


def _glibc():
    """glibc, or None on another C library."""
    global _libc
    if _libc is None and platform.libc_ver()[0] == "glibc":
        _libc = ctypes.CDLL("libc.so.6")
    return _libc


def pin_malloc_thresholds(mmap_threshold: int = 128 * 1024, trim_threshold: int = 1 << 20) -> bool:
    """Disable glibc's dynamic mmap-threshold adaptation: allocations above
    ``mmap_threshold`` always go to mmap, and free heap above
    ``trim_threshold`` at the top is released eagerly. Idempotent; returns
    False off glibc."""
    global _pinned
    libc = _glibc()
    if libc is None:
        return False
    ok = bool(libc.mallopt(M_MMAP_THRESHOLD, int(mmap_threshold))) and bool(
        libc.mallopt(M_TRIM_THRESHOLD, int(trim_threshold)))
    _pinned = _pinned or ok
    return ok


def malloc_thresholds_pinned() -> bool:
    """True once :func:`pin_malloc_thresholds` has succeeded in this process."""
    return _pinned


def trim_host_heap() -> bool:
    """Release free heap pages back to the OS (glibc ``malloc_trim(0)``);
    cheap at typical heap sizes, for every N groups of a streaming loop."""
    libc = _glibc()
    return bool(libc.malloc_trim(0)) if libc is not None else False
