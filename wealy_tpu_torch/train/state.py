"""Train state: the model, f32 parameters, the optimizer and the step
counter; the counterpart of ``wealy_tpu.train.state``.

Parameters are f32 and compute runs in the model's dtype, as in Flax
(f32 params cast at every call). The port keeps the model's bf16 weights as
that cast and holds **f32 master copies** beside them: AdamW updates the
masters and each step writes ``master.to(bf16)`` back into the module.
Parameters that are f32 in the module (LayerNorm, the MLP biases, a f32
model's every weight) are their own masters and are updated in place. So an
update smaller than one bf16 ulp of a weight accumulates in its master
instead of rounding away, and the extraction path keeps its bf16 module
unchanged. ``TrainState.params`` maps each parameter name to its f32 master.

The optimizer computes what ``make_optimizer`` computes in optax:
``clip_by_global_norm(1.0)`` (scale by max_norm / norm only when norm >=
max_norm), then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay
on every parameter) at the learning rate of
``warmup_cosine_decay_schedule(0, lr, warmup, max(max_steps, warmup + 1),
end=lr * 0.01)`` read at the update count BEFORE it is incremented, so the
first step runs at lr 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWSchedule:
    """Hyperparameters of the optimizer (optax's chain, see the module doc)."""

    lr: float = 1e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 1000
    max_steps: int = 100_000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_norm: float = 1.0

    def learning_rate(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule at update ``count``."""
        w = self.warmup_steps
        if count < w:  # linear_schedule(0, lr, w)
            return self.lr * count / w
        decay_steps = max(self.max_steps, w + 1) - w
        alpha = 0.01
        t = min(count - w, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return self.lr * ((1 - alpha) * cosine + alpha)


def make_optimizer(
    lr: float = 1e-4,
    weight_decay: float = 1e-4,
    warmup_steps: int = 1000,
    max_steps: int = 100_000,
) -> AdamWSchedule:
    """AdamW with linear warm-up and cosine decay, gradients clipped to
    global norm 1."""
    return AdamWSchedule(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                         max_steps=max_steps)


class TrainState:
    """``step``, the ``model`` (its trainable parameters), their f32
    ``params``, the AdamW ``opt_state`` ({"count", "mu", "nu"}) and the
    model's BatchNorm ``batch_stats``."""

    def __init__(self, model: nn.Module, tx: Optional[AdamWSchedule] = None, step: int = 0):
        self.model = model
        self.tx = tx or make_optimizer()
        self.step = int(step)
        self.trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        # names whose module weight is a lower-precision cast of its master
        self.cast = {n for n, p in self.trainable if p.dtype != torch.float32}
        self.params: Dict[str, torch.Tensor] = {
            n: p.detach().float().clone() if n in self.cast else p.data
            for n, p in self.trainable
        }
        self.opt_state = {
            "count": 0,
            "mu": {n: torch.zeros_like(m) for n, m in self.params.items()},
            "nu": {n: torch.zeros_like(m) for n, m in self.params.items()},
        }

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The model's BatchNorm running statistics (buffer name -> tensor,
        the module's own buffers: the train step updates them), empty for a
        model without BatchNorm."""
        return {n: b for n, b in self.model.named_buffers()
                if n.endswith(("running_mean", "running_var"))}

    @property
    def device(self) -> torch.device:
        return self.trainable[0][1].device

    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        grad_norm: Optional[torch.Tensor] = None) -> "TrainState":
        """One optimizer update from ``grads`` (name -> gradient, any float
        dtype); updates the masters, writes them back into the model and
        increments ``step``. Runs on the device without a host sync.
        ``grad_norm``: the global norm clipping takes, where this rank's
        gradients are shards of it (tensor parallelism); by default theirs."""
        tx = self.tx
        names = [n for n, _ in self.trainable]
        g = [grads[n].float() for n in names]
        g_norm = torch.sqrt(sum((t * t).sum() for t in g)) if grad_norm is None else grad_norm
        keep = g_norm < tx.max_norm
        g = [torch.where(keep, t, (t / g_norm) * tx.max_norm) for t in g]

        count = self.opt_state["count"]
        lr = tx.learning_rate(count)
        # optax's bias corrections, 1 - b ** (count + 1), are taken in f32
        n = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(tx.b1) ** n)
        bc2 = float(np.float32(1) - np.float32(tx.b2) ** n)
        mu, nu = self.opt_state["mu"], self.opt_state["nu"]
        for (name, p), t in zip(self.trainable, g):
            m = mu[name].mul_(tx.b1).add_(t, alpha=1.0 - tx.b1)
            v = nu[name].mul_(tx.b2).addcmul_(t, t, value=1.0 - tx.b2)
            master = self.params[name]
            update = (m / bc1) / (torch.sqrt(v / bc2) + tx.eps) + tx.weight_decay * master
            master.sub_(lr * update)
            if name in self.cast:
                p.data.copy_(master)
        self.opt_state["count"] = count + 1
        self.step += 1
        return self

    def load(self, params: Dict[str, torch.Tensor], opt_state: dict, step: int,
             batch_stats: Optional[Dict[str, torch.Tensor]] = None) -> "TrainState":
        """Restore masters, moments, count, step and the running statistics
        (checkpoint resume)."""
        own = self.batch_stats
        if set(batch_stats or {}) != set(own):
            raise ValueError(f"checkpoint batch_stats {sorted(batch_stats or {})} do not match "
                             f"the model's {sorted(own)}")
        for name, b in own.items():
            b.copy_(batch_stats[name])
        for name, p in self.trainable:
            self.params[name].copy_(params[name])
            self.opt_state["mu"][name].copy_(opt_state["mu"][name])
            self.opt_state["nu"][name].copy_(opt_state["nu"][name])
            if name in self.cast:
                p.data.copy_(self.params[name])
        self.opt_state["count"] = int(opt_state["count"])
        self.step = int(step)
        return self


def seeded_init_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init on a ``torch.Generator``: the CLEWS encoder's
    ``seeded_init_``, a model's own ``init_weights`` (Whisper), or the
    heads' ``seeded_init_`` (the heads and the fusion models)."""
    from wealy_tpu_torch.models import clews_encoder
    from wealy_tpu_torch.models.heads import seeded_init_ as head_init

    if isinstance(model, (clews_encoder.ClewsEncoder, clews_encoder.ClewsWindowEncoder)):
        return clews_encoder.seeded_init_(model, seed)
    if hasattr(model, "init_weights"):
        device = next(model.parameters()).device
        return model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return head_init(model, seed)


def create_train_state(
    model: nn.Module,
    tx: Optional[AdamWSchedule] = None,
    seed: int = 0,
    init: bool = True,
) -> TrainState:
    """A fresh TrainState; ``init`` draws the weights from ``seed`` first
    (pass False to keep weights already loaded)."""
    if init:
        seeded_init_(model, seed)
    return TrainState(model, tx or make_optimizer())
