"""Throughput counters, the counterpart of
``wealy_tpu.utils.profiling.ThroughputMeter``: steps/s and 30 s clips/s per
card, the unit of the split extraction's ``throughput`` report.

The trace helpers of the JAX module (``trace_span``, ``start_trace``,
``stop_trace`` on ``jax.profiler``) come with ROADMAP item 6
(``--profile`` on ``torch.profiler``).
"""

from __future__ import annotations

import time


class ThroughputMeter:
    """Windowed throughput: call ``tick(n_items)`` once per step.

    ``n_chips`` divides the per-card rate: 1, the one card the port's
    split jobs run on (extraction over several cards is ROADMAP item 6)."""

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
