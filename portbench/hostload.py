"""How fast the host ran during a window, reported beside the result
(``"host"``) so that a slow run can be told apart from a slow host; no
metric reads it.

- ``probe_ms``: the time of a fixed piece of pure-Python work (the kind of
  work a host-bound decode loop does between launches) at the window's
  opening and at its close: a host whose cores are shared or slowed reads
  higher;
- ``proc_cpu_per_wall``: this process's CPU seconds over the window's wall
  seconds (the cores its threads kept busy);
- ``threads``: the process's threads at the close.

(The machine-wide counters of ``/proc/stat`` and ``/proc/loadavg`` read
constant inside the card's sandbox, so they are not used.)
"""

from __future__ import annotations

import os
import time


def probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop, the best of three."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i & 7
        best = min(best, time.perf_counter() - t)
    return 1000.0 * best


def snapshot() -> dict:
    return {"t": time.perf_counter(), "proc_cpu_s": sum(os.times()[:2]), "probe_ms": probe_ms()}


def between(a: dict, b: dict) -> dict:
    wall = b["t"] - a["t"]
    threads = len(os.listdir("/proc/self/task")) if os.path.isdir("/proc/self/task") else None
    return {"wall_s": wall, "proc_cpu_per_wall": (b["proc_cpu_s"] - a["proc_cpu_s"]) / wall,
            "probe_ms": [a["probe_ms"], b["probe_ms"]], "threads": threads}
