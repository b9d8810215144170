"""Train and eval steps on one device: the counterpart of
``wealy_tpu.train.step``.

One train step = model forward on the batch -> metric loss -> gradients ->
optimizer update; ``(state, logdict)`` comes back with ``logdict["loss"]``.
``model_call(model, batch) -> z (B, zdim)`` adapts the model to the batch
dict; the default is ``model(batch["emb"], batch["mask"])`` (a head over
stored embeddings).

``grad_accum > 1`` is the GradCache two-pass step of the JAX package:
(1) embed the batch in ``grad_accum`` chunks under ``torch.no_grad()``;
(2) take the loss and dL/dz on the full (B, zdim) matrix, so the in-batch
negative set is the whole batch; (3) re-run each chunk with autograd and
backpropagate its slice of dz, accumulating the parameter gradients in f32.
Peak activation memory is one chunk's; the gradients equal the single-pass
step's up to the order of the sums.

``with_batch_stats``: the step of a model with BatchNorm (the CLEWS
encoder). The forward runs in training mode, so BatchNorm normalises with
the batch statistics, and the model's running statistics (the state's
``batch_stats``) are updated once per step by that forward, as the JAX
step threads ``batch_stats`` through ``mutable``. The default call is
``model(batch["emb"])``. ``grad_accum > 1`` with BatchNorm raises
``ValueError``, as in JAX: a chunked step would change the batch
statistics.

The mesh (data-parallel) step comes with the ``parallel/`` slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from wealy_tpu_torch.train.state import TrainState


def upcast_batch(batch: dict) -> dict:
    """Every array of the batch as a tensor, float16/bfloat16 widened to
    float32 (the input pipeline ships ``emb`` in the store's fp16)."""

    def up(x):
        x = torch.from_numpy(x) if isinstance(x, np.ndarray) else torch.as_tensor(x)
        return x.float() if x.dtype in (torch.float16, torch.bfloat16) else x

    return {k: up(v) for k, v in batch.items()}


def default_model_call(model, batch: dict):
    return model(batch["emb"], batch["mask"])


def batch_stats_model_call(model, batch: dict):
    return model(batch["emb"])


def loss_and_grads(
    state: TrainState,
    batch: dict,
    loss_fn: Callable,
    model_call: Callable = default_model_call,
    grad_accum: int = 1,
):
    """(loss, logdict, grads): the step's loss on the batch and the f32
    gradient of every trainable parameter (name -> tensor), without
    updating anything."""
    batch = upcast_batch(batch)
    names = [n for n, _ in state.trainable]
    params = [p for _, p in state.trainable]
    extra = {"global_step": state.step}
    labels, ids = batch["labels"], batch["ids"]

    def f32(gs):
        return [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                for g, p in zip(gs, params)]

    if grad_accum <= 1:
        with torch.enable_grad():
            z = model_call(state.model, batch)
            loss, logdict = loss_fn(labels, ids, z, extra)
            grads = f32(torch.autograd.grad(loss, params, allow_unused=True))
        return loss.detach(), logdict, dict(zip(names, grads))

    n = int(grad_accum)
    B = labels.shape[0]
    if B % n:
        raise ValueError(f"batch size {B} not divisible by grad_accum {n}")
    m = B // n
    chunks = [{k: v[i * m : (i + 1) * m] for k, v in batch.items()} for i in range(n)]
    # (1) activation-free embedding pass
    with torch.no_grad():
        z = torch.cat([model_call(state.model, c) for c in chunks])
    # (2) loss and dL/dz on the full embedding matrix
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        loss, logdict = loss_fn(labels, ids, z, extra)
        (dz,) = torch.autograd.grad(loss, z)
    # (3) re-run each chunk with autograd against its slice of dz
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    for i, c in enumerate(chunks):
        with torch.enable_grad():
            zc = model_call(state.model, c)
            gs = torch.autograd.grad(zc, params, grad_outputs=dz[i * m : (i + 1) * m],
                                     allow_unused=True)
        for a, g in zip(acc, gs):
            if g is not None:
                a.add_(g.float())
    return loss.detach(), logdict, dict(zip(names, acc))


def make_train_step(
    model,
    loss_fn: Callable,
    mesh=None,
    model_call: Optional[Callable] = None,
    with_batch_stats: bool = False,
    grad_accum: int = 1,
):
    """``step(state, batch) -> (state, logdict)`` (the state is updated in
    place and returned). ``model`` is unused beyond the signature of the
    JAX function: the step trains ``state.model``."""
    del model
    if grad_accum > 1 and with_batch_stats:
        raise ValueError("grad_accum is incompatible with batch_stats (BatchNorm) models")
    if mesh is not None:
        raise NotImplementedError(
            "the mesh (data-parallel) train step comes with the parallel/ slice of the port"
        )
    call = model_call or (batch_stats_model_call if with_batch_stats else default_model_call)

    def step(state: TrainState, batch: dict):
        if with_batch_stats:
            state.model.train()  # batch statistics in, running statistics updated
        loss, logdict, grads = loss_and_grads(state, batch, loss_fn, call, grad_accum)
        state.apply_gradients(grads)
        logdict: Dict[str, torch.Tensor] = {k: torch.as_tensor(v).detach()
                                            for k, v in logdict.items()}
        logdict["loss"] = loss
        return state, logdict

    return step


def make_eval_embed_step(model, mesh=None, model_call=None):
    """``embed(emb, mask) -> z`` without autograd (evaluation)."""
    if mesh is not None:
        raise NotImplementedError(
            "the mesh eval step comes with the parallel/ slice of the port"
        )
    call = model_call or (lambda m, emb, mask: m(emb, mask))

    def embed(emb, mask):
        with torch.no_grad():
            return call(model, emb, mask)

    return embed
