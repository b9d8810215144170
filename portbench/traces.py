"""Reading a ``torch.profiler`` (CUPTI) trace of the card.

:func:`capture` starts a profiler of the host and the card; :func:`read`
exports its Chrome trace under ``TMPDIR``, parses it, deletes the file and
returns a :class:`Trace`: the device's work (kernels, copies, sets) and the
host's spans inside a window given by two host markers. The busy time is the
length of the union of the device intervals (the arithmetic of
``trace_device_busy`` in the port's ``utils/profiling.py``, kept here so that
the yardstick does not move with the program).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

# the trace events that are work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the host events that say what the host was doing
HOST_CATEGORIES = ("user_annotation", "cpu_op", "python_function")
# the markers the drivers put around the traced window
WINDOW_START, WINDOW_END = "portbench.window_start", "portbench.window_end"


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    """The traced window (microseconds on the trace's clock)."""

    lo: float
    hi: float
    device: list  # [(name, start, end)] clipped to the window
    host: list  # [(name, start, end)] host spans overlapping the window

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged((s, e) for _, s, e in self.device)) / 1e6

    def kernel_s(self, fragment: str) -> tuple[float, int]:
        """(seconds, launches) of the device events whose name holds
        ``fragment``."""
        hits = [(s, e) for name, s, e in self.device if fragment in name]
        return sum(e - s for s, e in hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        by_name: dict = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host span, seconds]]: the device's idle time in the window,
        summed by what the host was doing at each gap's start (the outermost
        and the innermost host event open then), the longest first."""
        busy = merged((s, e) for _, s, e in self.device)
        gaps, cur = [], self.lo
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.hi > cur:
            gaps.append((cur, self.hi))
        host = sorted((s, -e, name) for name, s, e in self.host
                      if name not in (WINDOW_START, WINDOW_END))
        by_label: dict = {}
        active: list = []  # (start, end, name) of the host events open at the sweep
        k = 0
        for s, e in gaps:  # in time order: one sweep over the host events
            while k < len(host) and host[k][0] <= s:
                active.append((host[k][0], -host[k][1], host[k][2]))
                k += 1
            active = [a for a in active if a[1] > s]
            if active:
                outer = min(active, key=lambda a: (a[0], -a[1]))[2]
                inner = max(active, key=lambda a: (a[0], -a[1]))[2]
                label = outer if outer == inner else f"{outer} > {inner}"
            else:
                label = "(no host span)"
            by_label[label] = by_label.get(label, 0.0) + (e - s) / 1e6
        return [[k_, v] for k_, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:n]]


def capture():
    """A started profiler of the host and the card."""
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def read(prof) -> Optional[Trace]:
    """The trace of the stopped profiler ``prof`` between the window
    markers (exported under ``TMPDIR``, read, and the file deleted); None
    when the markers are missing."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return parse(events)


def parse(events: list) -> Optional[Trace]:
    """A :class:`Trace` from Chrome trace events."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    marks = {e["name"]: float(e["ts"]) for e in complete
             if e.get("name") in (WINDOW_START, WINDOW_END)}
    if len(marks) != 2:
        return None
    lo, hi = marks[WINDOW_START], marks[WINDOW_END]
    device, host = [], []
    for e in complete:
        s, d = float(e["ts"]), float(e["dur"])
        if s >= hi or s + d <= lo:
            continue
        if e.get("cat") in DEVICE_CATEGORIES:
            device.append((e["name"], max(s, lo), min(s + d, hi)))
        elif e.get("cat") in HOST_CATEGORIES:
            host.append((e["name"], s, s + d))
    return Trace(lo, hi, device, host)
