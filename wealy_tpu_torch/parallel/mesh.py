"""The data-parallel mesh, the counterpart of ``wealy_tpu.parallel.mesh``.

In the JAX package a mesh is a grid of devices in one program. In the port
it is a ``torch.distributed`` process group over the ``data`` axis, one
process per card (NCCL on cards, gloo on the CPU), each process holding a
replica of the state:

- :func:`make_mesh` gives the world size, this process's rank and its
  device; without an initialised process group it is a one-rank
  mesh on which every collective below is the identity (a one-rank group,
  once initialised, runs its collectives through the backend);
- :func:`data_sharding` is the local shard of a global batch (rank r holds
  the r-th of ``world_size`` equal contiguous slices of the batch axis, as
  ``NamedSharding(mesh, P("data"))`` places them); a leaf whose batch axis
  does not divide the world size stays whole on every rank, as the JAX
  ``shard_batch`` places it unsharded;
- :func:`replicated` broadcasts tensors from rank 0 in place (the JAX
  ``replicated`` sharding of a state put on the mesh);
- :func:`all_gather_rows`, :func:`gather_with_local_grad` and
  :func:`all_reduce_sum` are the collectives of the train step.

Tensor-parallel meshes (a ``model`` axis) are ROADMAP item 6d.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Sequence

import torch
import torch.distributed as dist

from wealy_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of the ``data`` axis: ``world_size`` ranks, this
    process's ``rank``, the ``device`` its replica lives on, and whether the
    default process group carries the collectives (``distributed``; False:
    one rank and no group)."""

    world_size: int
    rank: int
    device: torch.device
    distributed: bool = False

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def make_mesh(axis_names: Sequence[str] = ("data",), device=None) -> Mesh:
    """The mesh of the initialised default process group, or a one-rank
    mesh when none is initialised. ``device`` is the card unless
    the caller asks for the CPU; a card without an index is the process's
    ``LOCAL_RANK`` (``torchrun``), else its rank modulo the card count."""
    if tuple(axis_names) != ("data",):
        raise NotImplementedError(
            f"mesh axes {tuple(axis_names)}: only the data axis is ported; tensor and "
            "pipeline axes are ROADMAP item 6d")
    distributed = dist.is_available() and dist.is_initialized()
    if distributed:
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else rank % torch.cuda.device_count())
    return Mesh(world, rank, dev, distributed)


def data_sharding(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``axis``; ``x`` itself
    when the axis does not divide the world size (or on one rank)."""
    n = x.shape[axis]
    if n % mesh.world_size:
        return x
    m = n // mesh.world_size
    return x.narrow(axis, mesh.rank * m, m)


def replicated(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> list:
    """Broadcast every tensor from rank 0 in place; returns them."""
    tensors = list(tensors)
    if mesh.distributed:
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tensors


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in rank order (no autograd);
    bool tensors travel as uint8."""
    if not mesh.distributed:
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.world_size)]
    dist.all_gather(parts, wire)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


def gather_with_local_grad(mesh: Mesh, z: torch.Tensor) -> torch.Tensor:
    """The global (B, ...) ``z`` from every rank's rows, with this rank's
    own rows the autograd input: the gradient reaches the local rows only,
    and :func:`all_reduce_sum` of the parameter gradients then gives the
    single-device gradient of the global batch once (not ``world_size``
    times, as an autograd all-gather on top of that reduction would)."""
    if not mesh.distributed:
        return z
    parts = list(all_gather_rows(mesh, z.detach()).chunk(mesh.world_size))
    parts[mesh.rank] = z
    return torch.cat(parts)


def all_reduce_sum(mesh: Mesh, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The sum over ranks of each gradient (one flat f32 all-reduce)."""
    if not mesh.distributed:
        return grads
    names = list(grads)
    flat = torch.cat([grads[n].float().reshape(-1) for n in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out, offset = {}, 0
    for n in names:
        k = grads[n].numel()
        out[n] = flat[offset : offset + k].view(grads[n].shape)
        offset += k
    return out


def replicate_state(mesh: Mesh, state) -> None:
    """Broadcast a ``TrainState`` from rank 0 in place: its f32 masters, the
    module's parameters and buffers, the AdamW moments, and the step and
    update count."""
    if not mesh.distributed:
        return
    model = state.model
    replicated(mesh, [*state.params.values(), *model.parameters(), *model.buffers(),
                      *state.opt_state["mu"].values(), *state.opt_state["nu"].values()])
    counters = torch.tensor([state.step, state.opt_state["count"]], dtype=torch.int64,
                            device=mesh.device)
    replicated(mesh, [counters])
    state.step, state.opt_state["count"] = (int(v) for v in counters.tolist())
