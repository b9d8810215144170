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

On a mesh with a ``model`` axis (tensor parallelism, ``parallel/tp.py``)
the model holds each rank's shard: the gradients are reduced over ``data``
only, and clipping takes the global norm of the sharded gradients
(``tp_grad_norm``). On a ``stage`` axis (``parallel/pp.py``) the pipelined
encoder hands every rank the whole gradient.

With a ``mesh`` (``parallel/mesh.py``, one process per card) the step takes
the GLOBAL batch, as the JAX step takes the global sharded batch, and gives
the single-device step's loss and update: each rank embeds its own rows
(:func:`shard_batch`), the loss runs over the gathered global batch
(``parallel/collectives.py::global_batch_loss``, the gradient reaching each
rank's own rows), and the parameter gradients are summed over the ranks
before the optimizer, which every rank runs on its replica. ``grad_accum >
1`` chunks each rank's rows, gathers the chunked embeddings and slices each
rank's rows of dL/dz back. A batch whose size does not divide the world
size, and a BatchNorm step (whose statistics JAX's mesh step takes over the
whole global batch), run whole on every rank with no reduction.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from wealy_tpu_torch.parallel.collectives import global_batch_loss
from wealy_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    data_sharding,
)
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
    mesh: Optional[Mesh] = None,
):
    """(loss, logdict, grads): the step's loss on the batch and the f32
    gradient of every trainable parameter (name -> tensor), without
    updating anything. With a ``mesh``, ``batch`` is this rank's shard of
    the global batch: the loss is the global batch's and the gradients are
    summed over the ranks."""
    batch = upcast_batch(batch)
    names = [n for n, _ in state.trainable]
    params = [p for _, p in state.trainable]
    extra = {"global_step": state.step}
    sharded = mesh is not None and mesh.distributed
    labels, ids = batch["labels"], batch["ids"]

    def f32(gs):
        return [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                for g, p in zip(gs, params)]

    def reduced(grads: dict) -> dict:
        return all_reduce_sum(mesh, grads) if sharded else grads

    if grad_accum <= 1:
        wrapped = global_batch_loss(loss_fn, mesh) if sharded else loss_fn
        with torch.enable_grad():
            z = model_call(state.model, batch)
            loss, logdict = wrapped(labels, ids, z, extra)
            grads = f32(torch.autograd.grad(loss, params, allow_unused=True))
        return loss.detach(), logdict, reduced(dict(zip(names, grads)))

    n = int(grad_accum)
    B = labels.shape[0]
    if B % n:
        raise ValueError(f"batch size {B} not divisible by grad_accum {n}"
                         + (" (this rank's rows of the global batch)" if sharded else ""))
    m = B // n
    chunks = [{k: v[i * m : (i + 1) * m] for k, v in batch.items()} for i in range(n)]
    # (1) activation-free embedding pass
    with torch.no_grad():
        z = torch.cat([model_call(state.model, c) for c in chunks])
    # (2) loss and dL/dz on the full embedding matrix (every rank's rows)
    if sharded:
        z, labels, ids = (all_gather_rows(mesh, t) for t in (z, labels, ids))
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        loss, logdict = loss_fn(labels, ids, z, extra)
        (dz,) = torch.autograd.grad(loss, z)
    if sharded:
        dz = dz[mesh.index("data") * B : (mesh.index("data") + 1) * B]
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
    return loss.detach(), logdict, reduced(dict(zip(names, acc)))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every leaf of a global batch dict, on the mesh's
    device (``data_sharding``: a leaf whose batch axis does not divide the
    world size, or a scalar, is placed whole, as the JAX ``shard_batch``
    places it unsharded)."""

    def put(x):
        x = torch.from_numpy(x) if isinstance(x, np.ndarray) else torch.as_tensor(x)
        if x.ndim == 0:
            return x.to(mesh.device)
        return data_sharding(mesh, x).to(mesh.device)

    return {k: put(v) for k, v in batch.items()}


def _split_evenly(batch: dict, mesh: Mesh) -> bool:
    """Whether the batch is split over a process group: every leaf with a
    batch axis divides the data axis."""
    return mesh.distributed and all(
        np.ndim(v) == 0 or np.shape(v)[0] % mesh.size("data") == 0 for v in batch.values())


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
    JAX function: the step trains ``state.model``. With ``mesh``, ``batch``
    is the global batch (host or device tensors) and every rank runs the
    step (see the module doc)."""
    del model
    if grad_accum > 1 and with_batch_stats:
        raise ValueError("grad_accum is incompatible with batch_stats (BatchNorm) models")
    call = model_call or (batch_stats_model_call if with_batch_stats else default_model_call)

    def step(state: TrainState, batch: dict):
        if with_batch_stats:
            state.model.train()  # batch statistics in, running statistics updated
        on_mesh = None
        if mesh is not None:
            if _split_evenly(batch, mesh) and not with_batch_stats:
                batch, on_mesh = shard_batch(batch, mesh), mesh
            else:  # the whole batch on every rank: the same gradients everywhere
                batch = {k: torch.as_tensor(v).to(mesh.device) for k, v in batch.items()}
        loss, logdict, grads = loss_and_grads(state, batch, loss_fn, call, grad_accum,
                                              mesh=on_mesh)
        norm = None
        if mesh is not None and mesh.size("model") > 1:
            from wealy_tpu_torch.parallel.tp import tp_grad_norm

            norm = tp_grad_norm(grads, mesh)
        state.apply_gradients(grads, grad_norm=norm)
        logdict: Dict[str, torch.Tensor] = {k: torch.as_tensor(v).detach()
                                            for k, v in logdict.items()}
        logdict["loss"] = loss
        return state, logdict

    return step


def make_eval_embed_step(model, mesh: Optional[Mesh] = None, model_call=None):
    """``embed(emb, mask) -> z`` without autograd (evaluation). With a
    ``mesh``, each rank embeds its rows of the batch and the ranks' rows are
    gathered, so every rank returns the whole batch's z (a batch that does
    not divide the world size is embedded whole on every rank)."""
    call = model_call or (lambda m, emb, mask: m(emb, mask))

    def embed(emb, mask):
        with torch.no_grad():
            if mesh is None or not _split_evenly({"emb": emb, "mask": mask}, mesh):
                return call(model, emb, mask)
            local = shard_batch({"emb": emb, "mask": mask}, mesh)
            return all_gather_rows(mesh, call(model, local["emb"], local["mask"]))

    return embed
