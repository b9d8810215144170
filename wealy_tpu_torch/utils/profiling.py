"""Tracing and throughput counters, the counterpart of
``wealy_tpu.utils.profiling``:

- :class:`trace_span`: a named span. Every span is kept, with its start,
  end and thread on the ``time.perf_counter`` clock, in one bounded
  process-wide ring (the last :data:`RING_SIZE` entries); while a profiler
  runs on the calling thread it is also a ``record_function`` in the
  captured trace. ``device=`` (a ``torch.device``; when it is a card) also
  times it on the card with a pair of CUDA events, read lazily (for a few
  coarse spans a batch). :func:`spans` reads the ring over a window of the
  host clock.
- :func:`start_trace` / :func:`stop_trace`: capture a trace of the host and
  the card (``torch.profiler`` with the CPU and, where a card is present,
  the CUDA activities) into a directory, as a Chrome / TensorBoard trace
  file ``<dir>/<worker>.<time>.pt.trace.json``; :func:`profiled` wraps a
  whole command in one (``--profile DIR``), and stops the trace on an error
  too.
- :func:`trace_device_busy`: the device's busy share of a trace file's
  window (the union of its kernel, copy and set intervals).
- :class:`ThroughputMeter`: steps/s and 30 s clips/s per card, the unit of
  the split extraction's ``throughput`` report.
"""

from __future__ import annotations

import collections
import contextlib
import json
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PROFILER: Optional[torch.profiler.profile] = None
# the trace events that are work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the ring's length: about 300 batches of the hs_last_seq job's spans
RING_SIZE = 65536
_RING: collections.deque = collections.deque(maxlen=RING_SIZE)
# bound once: a span is on the hot path of the decode loop
_profiler_enabled = torch.autograd._profiler_enabled
_clock = time.perf_counter
_thread = threading.get_ident


class trace_span:
    """A named span (a context manager), kept in the ring when it closes:
    ``name``, ``t0`` / ``t1`` (``time.perf_counter`` at its entry and exit),
    ``thread`` (``threading.get_ident``), ``n`` (a number the caller may set
    inside it, e.g. the chunks of a song; None otherwise) and
    :attr:`device_ms`. ``record_function`` is opened only while a profiler
    runs on the calling thread, so a span costs a clock read and an append
    otherwise."""

    __slots__ = ("name", "n", "t0", "t1", "thread", "_device", "_rf", "_events", "_ms")

    def __init__(self, name: str, device: Optional[torch.device] = None):
        self.name, self._device = name, device
        self.n = self._rf = self._events = self._ms = None

    def __enter__(self) -> "trace_span":
        self.t0 = _clock()
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self._device is not None and self._device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start, None)
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events = (self._events[0], end)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.t1 = _clock()
        self.thread = _thread()
        _RING.append(self)
        return False

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two events on the card (waits
        for the second), or None where none were recorded."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._ms, self._events = start.elapsed_time(end), None
        return self._ms


def spans(since: Optional[float] = None, until: Optional[float] = None) -> list:
    """The ring's spans that ended in [``since``, ``until``]
    (``time.perf_counter``; open ends by default), oldest first."""
    return [s for s in list(_RING)
            if (since is None or s.t1 >= since) and (until is None or s.t1 <= until)]


def start_trace(log_dir: str) -> None:
    """Start capturing a host (and card) trace that :func:`stop_trace`
    writes into ``log_dir``."""
    global _PROFILER
    if _PROFILER is not None:
        raise RuntimeError("a trace is already being captured")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    _PROFILER = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    _PROFILER.start()


def stop_trace() -> None:
    """Stop the trace and write its file."""
    global _PROFILER
    prof, _PROFILER = _PROFILER, None
    if prof is None:
        raise RuntimeError("no trace is being captured")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def profiled(log_dir: str, name: str):
    """A trace of the enclosed work in ``log_dir``, inside one span ``name``;
    the trace is written on an error too."""
    start_trace(log_dir)
    with contextlib.ExitStack() as stack:
        stack.callback(lambda: print(f"[profile] trace written to {log_dir}", file=sys.stderr))
        stack.callback(stop_trace)
        with trace_span(name):
            yield


def trace_files(log_dir: str) -> list:
    """The trace files under ``log_dir``, oldest first."""
    return sorted(Path(log_dir).glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)


def _union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def trace_device_busy(trace_file, span: str) -> dict:
    """The device's work in a trace file: ``window_ms`` (from the first
    start to the last end of the spans named ``span``), ``busy_ms`` (the
    union of the kernel, copy and set intervals inside it), ``busy_share``
    and ``by_name`` ({kernel name: [ms, count]} over the whole trace)."""
    events = [e for e in json.loads(Path(trace_file).read_text()).get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("name") == span]
    if not spans:
        raise ValueError(f"{trace_file} holds no span {span!r}")
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    busy = _union_us((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device
                     if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    by_name: dict = {}
    for e in device:
        rec = by_name.setdefault(e["name"], [0.0, 0])
        rec[0] += e["dur"] / 1e3
        rec[1] += 1
    window = (hi - lo) / 1e3
    return {"window_ms": window, "busy_ms": busy / 1e3,
            "busy_share": busy / 1e3 / window if window > 0 else 0.0, "by_name": by_name}


class ThroughputMeter:
    """Windowed throughput: call ``tick(n_items)`` once per step.

    ``n_chips`` divides the per-card rate: the data-parallel world size of
    the job (1 for the one card the split jobs run on)."""

    def __init__(self, window: int = 50, n_chips: int = 1):
        self.window = window
        self.n_chips = n_chips
        self._stamps: list[tuple[float, int]] = []
        self.total_items = 0
        self.total_steps = 0

    def tick(self, n_items: int = 1) -> None:
        now = time.perf_counter()
        self._stamps.append((now, n_items))
        if len(self._stamps) > self.window:
            self._stamps.pop(0)
        self.total_items += n_items
        self.total_steps += 1

    @property
    def steps_per_sec(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1][0] - self._stamps[0][0]
        return (len(self._stamps) - 1) / dt if dt > 0 else 0.0

    @property
    def items_per_sec(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1][0] - self._stamps[0][0]
        items = sum(n for _, n in self._stamps[1:])
        return items / dt if dt > 0 else 0.0

    @property
    def items_per_sec_per_chip(self) -> float:
        return self.items_per_sec / max(1, self.n_chips)

    def report(self) -> dict:
        return {
            "steps_per_sec": round(self.steps_per_sec, 3),
            "items_per_sec": round(self.items_per_sec, 2),
            "items_per_sec_per_chip": round(self.items_per_sec_per_chip, 2),
            "total_steps": self.total_steps,
            "total_items": self.total_items,
        }
