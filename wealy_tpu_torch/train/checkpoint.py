"""Checkpoints of the train state as ``torch.save`` files, the counterpart of
``wealy_tpu.train.checkpoint`` (which writes orbax directories; those need
JAX to read, so the port neither reads nor writes them).

``<directory>/ckpt_<step>.pt`` holds the payload ``{"step", "params",
"opt_state"[, "batch_stats"]}`` (``batch_stats``: the BatchNorm running
statistics, for a model with BatchNorm): ``params`` maps each trainable parameter name to its f32
value, which is also a state dict that ``load_state_dict`` takes, so
``evaluate --checkpoint`` reads a trained head from it directly. The
data-order sidecar ``data_state_<step>.json`` sits beside it. The
``keep_n`` newest payloads are kept.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Save / restore train-state payloads by step, keeping the newest ``keep_n``."""

    def __init__(self, directory: str | Path, keep_n: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n

    def path(self, step: int) -> Path:
        return self.directory / f"ckpt_{int(step)}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Any) -> None:
        tmp = self.directory / f".ckpt_{int(step)}.pt.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))  # a reader never sees a partial file
        for old in self.all_steps()[: -self.keep_n]:
            self.path(old).unlink()
            (self.directory / f"data_state_{old}.json").unlink(missing_ok=True)

    def restore(self, step: Optional[int] = None) -> Any:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def save_state(self, state, data_state: Optional[dict] = None) -> None:
        """Persist the state's resumable parts (the optimizer's
        hyperparameters are code) and, when given, the data-order sidecar
        ``data_state`` (e.g. ``{"epoch": e, "next_batch": b}``)."""

        def host(tree):
            return {k: host(v) if isinstance(v, dict) else
                    (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                    for k, v in tree.items()}

        payload = {"step": int(state.step), "params": host(state.params),
                   "opt_state": host(state.opt_state)}
        if state.batch_stats:
            payload["batch_stats"] = host(state.batch_stats)
        self.save(state.step, payload)
        if data_state is not None:
            p = self.directory / f"data_state_{int(state.step)}.json"
            tmp = p.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(data_state))
            tmp.replace(p)

    def restore_data_state(self, step: Optional[int] = None) -> Optional[dict]:
        """The data-order sidecar saved with ``save_state``, or None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        p = self.directory / f"data_state_{int(step)}.json"
        return json.loads(p.read_text()) if p.exists() else None

    def restore_state(self, state):
        """Load the latest payload into an initialised TrainState (masters,
        moments, count, step, running statistics, and the model's
        weights)."""
        payload = self.restore()
        return state.load(payload["params"], payload["opt_state"], payload["step"],
                          payload.get("batch_stats"))
