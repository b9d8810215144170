"""What every run shares: finding a cell and its files by name, the checks
on the card and on JAX, the per-layer readers, and the result line.

A cell is found by its name in ``BENCHMARK.json``: its entry names the
configuration, whose entry names the configuration's file; the cell's own
file is ``portbench/workloads/<cell>.json`` and names its driver
(``portbench/drivers/<driver>.py``); each per-layer metric is read by
``portbench/metrics/<metric>.py``. Adding a cell, a configuration or a metric
adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "wealy_tpu")


@dataclasses.dataclass
class Context:
    """What a driver's ``run`` gets."""

    name: str
    cell: dict  # the cell's own file
    config: dict  # the configuration's file
    seed: int
    seconds: float
    trace: bool
    t0: float  # perf_counter at the start of the process
    device: object  # torch.device
    variant: str = "program"  # "control": the cell's control path in the program's place
    fault: Optional[Callable] = None  # tests: wraps the program's function


def load_spec(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell's file, the configuration's file)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    cell["chips"] = entry["chips"]
    return bench, cell, config


def require_cards(n: int):
    """The first card, or None (with a message) when fewer than ``n`` are
    there: the benchmark never falls back to the CPU."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        print(f"portbench: the cell needs {n} CUDA card(s), this machine has {count}",
              file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def set_cache_env() -> None:
    """Kernel caches inside the checkout, at fixed paths; no JAX through a
    library that would load it."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> list:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole (``wealy_tpu_torch`` is not ``wealy_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(record)`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def end_to_end_entries(bench: dict, name: str) -> list:
    return [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]


def per_layer_entries(bench: dict, name: str) -> list:
    moves = {m["name"] for m in end_to_end_entries(bench, name)}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number at or under its
    limit, and at least one song checked."""
    checks, ok = {}, numbers.get("songs_checked", 0) >= 1
    for key, limit in limits.items():
        value = numbers.get(key)
        checks[key] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None and value <= limit
    checks["songs_checked"] = {"value": numbers.get("songs_checked", 0), "limit": 1,
                               "at_least": True}
    return ok, checks


def result(bench: dict, ctx: Context, out: dict) -> dict:
    """The result line of a run from the driver's output."""
    import torch

    correct, checks = judge(out["checks"], ctx.cell["check"]["limits"])
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    metrics, device = {}, {
        "platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
        "kind": torch.cuda.get_device_name(0) if ctx.device.type == "cuda" else "cpu",
        "count": ctx.cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if not ctx.trace:
        for m in end_to_end_entries(bench, ctx.name):
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    else:
        record = out["record"]
        for m in per_layer_entries(bench, ctx.name):
            value = metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        trace = record.get("trace")
        if trace is not None:
            device["busy_s"], device["window_s"] = trace.busy_s, trace.window_s
            breakdown = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    line["metrics"] = metrics
    line["device"] = device
    if breakdown is not None:
        line["breakdown"] = breakdown
    if out.get("host") is not None:
        line["host"] = out["host"]
    line["checks"] = checks
    return line
