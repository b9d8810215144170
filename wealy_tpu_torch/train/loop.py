"""Training loop: seeded sampler epochs -> collate -> device -> train step, the
counterpart of ``wealy_tpu.train.loop``. Metrics go through the
``(loss, logdict)`` channel to :class:`MetricsWriter`."""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from wealy_tpu_torch.data.chunking import collate_fixed_length
from wealy_tpu_torch.data.sampler import CliqueSampler
from wealy_tpu_torch.train.state import TrainState
from wealy_tpu_torch.utils.prefetch import prefetch
from wealy_tpu_torch.utils.profiling import trace_span


class MetricsWriter:
    """Sink of the (loss, logdict) channel: in-memory history, periodic
    printing and optional JSONL (one record per step). Logdict values stay
    device tensors until a drain (every ``log_every`` steps, every
    ``DRAIN_EVERY`` records, or an accessor), so steps stay in flight; each
    record's ``t`` is the host time of its ``write``."""

    DRAIN_EVERY = 64

    def __init__(self, log_every: int = 50, printer: Callable[[str], None] = print,
                 jsonl_path: Optional[str] = None):
        self.log_every = log_every
        self.printer = printer
        self._history: list[dict] = []
        self._pending: list[tuple[int, float, dict]] = []
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    def write(self, step: int, logdict: dict) -> None:
        self._pending.append((step, time.time(), logdict))
        due = bool(self.log_every) and step % self.log_every == 0
        if due or len(self._pending) >= self.DRAIN_EVERY:
            self._drain()
            if due:
                parts = " ".join(f"{k}={v:.4g}" for k, v in self._history[-1].items()
                                 if k not in ("step", "t"))
                self.printer(f"[step {step}] {parts}")

    def _drain(self) -> None:
        for step, t_write, logdict in self._pending:
            scalars = {k: float(v) for k, v in logdict.items() if np.ndim(v) == 0}
            scalars["step"] = step
            scalars["t"] = t_write
            self._history.append(scalars)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(scalars) + "\n")
        if self._pending and self._jsonl is not None:
            self._jsonl.flush()
        self._pending.clear()

    @property
    def history(self) -> list[dict]:
        """The per-step scalar records (drains the deferred ones)."""
        self._drain()
        return self._history

    def close(self) -> None:
        self._drain()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def batch_to_device(batch, device=None, transfer_dtype=np.float16) -> dict:
    """Collated Batch -> the dict the train step consumes (labels and ids
    int32, ``emb`` in ``transfer_dtype``, the store's fp16 by default, and
    the mask), as tensors on ``device`` (host tensors when None). The step
    widens ``emb`` to f32 (:func:`wealy_tpu_torch.train.step.upcast_batch`)."""
    labels, ids, emb, mask = batch.flatten_versions()
    arrays = {
        "labels": np.asarray(labels, np.int32),
        "ids": np.asarray(ids, np.int32),
        "emb": np.asarray(emb, transfer_dtype),
        "mask": np.asarray(mask),
    }
    return {k: torch.from_numpy(v).to(device) if device is not None else torch.from_numpy(v)
            for k, v in arrays.items()}


def fit(
    state: TrainState,
    train_step: Callable,
    sampler: CliqueSampler,
    *,
    batch_size: int = 32,
    chunk_size: int = 1000,
    max_steps: int = 1000,
    epochs: Optional[int] = None,
    writer: Optional[MetricsWriter] = None,
    checkpoint_manager=None,
    checkpoint_every: int = 1000,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 1000,
    mesh=None,
    prefetch_depth: int = 2,
    data_seed: int = 0,
    start_epoch: int = 0,
    start_batch: int = 0,
    make_batch: Optional[Callable] = None,
):
    """Train until ``max_steps``, or until ``epochs`` whole epochs have run
    when that comes first; returns (state, writer).

    Batches come from the sampler's seekable stream (``epoch_batches``
    seeded by ``data_seed``), collated (``collate_fixed_length`` with random
    windows) and placed on the state's device by a background thread,
    ``prefetch_depth`` ahead. ``eval_fn(state) -> dict`` runs every ``eval_every`` steps,
    written with a ``val_`` prefix. Checkpoints carry a ``{"epoch",
    "next_batch", "data_seed", "batch_size"}`` sidecar, and ``start_epoch``
    / ``start_batch`` resume the exact data order of the uninterrupted run.
    Checkpoints are written every ``checkpoint_every`` steps and once at
    the end. An epoch with no batch (fewer items than ``batch_size``)
    raises. ``make_batch(items, batch_rng) -> dict`` of arrays replaces the
    single-modal collate (the fusion models' collate and
    ``train/multimodal.py::flatten_multimodal_batch``). ``mesh`` (the
    data-parallel mesh of ``parallel/mesh.py``): every rank draws the same
    seeded global batches, which stay on the host for the mesh step to take
    its rows of (``train/step.py::shard_batch``), and only rank 0 writes
    checkpoints.
    """
    writer = writer or MetricsWriter()
    # under a mesh the step places its own rows; one process writes checkpoints
    device = state.device if mesh is None else None
    if mesh is not None and not mesh.is_primary:
        checkpoint_manager = None

    def produce(entry):
        _, brng, items = entry
        if make_batch is not None:
            arrays = {k: torch.from_numpy(np.asarray(v)) for k, v in make_batch(items, brng).items()}
            return arrays if device is None else {k: v.to(device) for k, v in arrays.items()}
        batch = collate_fixed_length(items, chunk_size=chunk_size, use_random_chunks=True,
                                     rng=brng)
        return batch_to_device(batch, device)

    step = int(state.step)
    epoch = int(start_epoch)
    first_start = int(start_batch)
    epochs_run = 0
    done = False
    saved_at = None
    data_state = None
    while not done and (epochs is None or epochs_run < epochs):
        n_avail = sampler.n_batches(batch_size)
        if first_start >= n_avail > 0:  # resumed exactly at an epoch boundary
            epoch += 1
            first_start = 0
            continue
        stream = sampler.epoch_batches(epoch, batch_size, first_start)
        n_batches = 0
        for b, batch in enumerate(prefetch(stream, depth=prefetch_depth, transform=produce),
                                  start=first_start):
            n_batches += 1
            with trace_span("train.step"):
                state, logdict = train_step(state, batch)
            step += 1
            writer.write(step, logdict)
            if eval_fn is not None and step % eval_every == 0:
                writer.write(step, {f"val_{k}": v for k, v in eval_fn(state).items()})
            data_state = {"epoch": epoch, "next_batch": b + 1,
                          "data_seed": data_seed, "batch_size": batch_size}
            if checkpoint_manager is not None and step % checkpoint_every == 0:
                checkpoint_manager.save_state(state, data_state=data_state)
                saved_at = step
            if step >= max_steps:
                done = True
                break
        if n_batches == 0 and not done:
            raise ValueError(
                f"sampler produced no batches: {len(sampler.versions)} items with "
                f"batch_size={batch_size} (incomplete batches are dropped). Reduce "
                "train.batch_size or check dataset filters."
            )
        epoch += 1
        epochs_run += 1
        first_start = 0
    if checkpoint_manager is not None and saved_at != step:
        checkpoint_manager.save_state(state, data_state=data_state)
    return state, writer
