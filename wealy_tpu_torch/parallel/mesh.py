"""The mesh of the port, the counterpart of ``wealy_tpu.parallel.mesh``.

In the JAX package a mesh is a grid of devices in one program. In the port
it is a grid of ``torch.distributed`` ranks, one process per card (NCCL on
cards, gloo on the CPU or where more ranks than cards share one card), each
process holding its own part of the state:

- :func:`make_mesh` lays the world's ranks out on named axes, row-major
  with the last axis innermost (``("data",)``, or ``("data", "model")``,
  ``("data", "stage")``, ``("data", "cp")``: neighbouring ranks share the
  inner axis, as the JAX ``make_tp_mesh`` / ``make_pp_mesh`` put ``model``
  and ``stage`` innermost), and makes one ``dist.new_group`` per line of
  every axis; without an initialised process group it is a one-rank mesh on
  which every collective below is the identity (a one-rank group, once
  initialised, runs its collectives through the backend);
- :func:`data_sharding` is the local shard of a global batch (the rank at
  data coordinate d holds the d-th of ``size("data")`` equal contiguous
  slices of the batch axis, as ``NamedSharding(mesh, P("data"))`` places
  them); a leaf whose batch axis does not divide the data axis stays whole
  on every rank, as the JAX ``shard_batch`` places it unsharded;
- :func:`shard_rows` runs a batch function data parallel (each rank its
  rows, the outputs gathered);
- :func:`replicated` broadcasts tensors from rank 0 in place (the JAX
  ``replicated`` sharding of a state put on the mesh);
- :func:`all_gather_rows`, :func:`gather_with_local_grad` and
  :func:`all_reduce_sum` are the collectives of the data-parallel train
  step; :func:`all_reduce`, :func:`all_gather`, :func:`reduce_scatter`,
  :func:`broadcast`, :func:`send`, :func:`recv` and :func:`exchange` run
  over one named axis, and :func:`collective` makes a pair of them one
  autograd operator (forward one, backward the other: the Megatron
  operators of ``tp.py``).

gloo takes the collectives of CUDA tensors but not their point-to-point
sends (on the card its ``send``/``recv`` abort the process:
``chip_smoke.py`` phase 25 probes each operation); where it carries a
card's tensors, every operation here stages them through host memory (a
copy out, the operation, a copy back), one rule for all, so a program of
several ranks on one card computes on the card and moves its activations
through the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from wealy_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of the mesh: ``world_size`` ranks laid out on
    ``axis_names`` with ``shape`` ranks each (row-major, last axis
    innermost), this process's ``rank``, the ``device`` its part of the
    state lives on, whether a process group carries the collectives
    (``distributed``; False: one rank and no group), and one process group
    per axis (None: the default group, for an axis that spans the world)."""

    world_size: int
    rank: int
    device: torch.device
    distributed: bool = False
    axis_names: Tuple[str, ...] = ("data",)
    shape: Optional[Tuple[int, ...]] = None
    groups: Optional[Tuple] = None

    def __post_init__(self):
        if self.shape is None:
            object.__setattr__(self, "shape", (self.world_size,) + (1,) * (len(self.axis_names) - 1))
        if self.groups is None:
            object.__setattr__(self, "groups", (None,) * len(self.axis_names))

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def size(self, axis: str = "data") -> int:
        """Ranks along ``axis`` (1 for an axis the mesh does not have)."""
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def coords(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def index(self, axis: str = "data") -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords()[self.axis_names.index(axis)] if axis in self.axis_names else 0

    def group(self, axis: str = "data"):
        return self.groups[self.axis_names.index(axis)]

    def peer(self, axis: str, index: int) -> int:
        """The global rank at coordinate ``index`` (mod the axis size) along
        ``axis``, with this rank's other coordinates."""
        c = list(self.coords())
        a = self.axis_names.index(axis)
        c[a] = index % self.shape[a]
        return int(np.ravel_multi_index(c, self.shape))

    def active(self, axis: str) -> bool:
        """Whether collectives over ``axis`` go through the backend: a group
        is up and the axis has several ranks (or, for an axis that spans
        the world, as the data axis of a one-rank group, any)."""
        if not self.distributed:
            return False
        return self.size(axis) > 1 or (axis in self.axis_names and self.group(axis) is None)


def _local_card(rank: int) -> torch.device:
    """The process's card: ``LOCAL_RANK`` (``torchrun``), else its rank,
    modulo the card count (several ranks may share one card)."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """The mesh of the initialised default process group over
    ``axis_names`` (``shape``: ranks per axis, default the whole world on
    the first axis and 1 on the others, as the JAX ``make_mesh``), or a
    one-rank mesh when none is initialised. ``device`` is the card unless
    the caller asks for the CPU; a card without an index is the process's
    (:func:`_local_card`). Every rank calls it, in the same order: it
    creates the axes' process groups."""
    axis_names = tuple(axis_names)
    distributed = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if distributed else (1, 0)
    shape = tuple(int(s) for s in shape) if shape is not None else \
        (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not hold the "
                         f"{world} rank(s) of the process group")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = _local_card(rank)
    groups = []
    grid = np.arange(world).reshape(shape)
    for a, n in enumerate(shape):
        if not distributed or n == world:
            groups.append(None)
            continue
        mine = None
        lines = np.moveaxis(grid, a, -1).reshape(-1, n)
        for line in lines:  # every rank creates every group, in one order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = g
        groups.append(mine)
    return Mesh(world, rank, dev, distributed, axis_names, shape, tuple(groups))


def data_sharding(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``axis`` (its data
    coordinate's); ``x`` itself when the axis does not divide the data axis
    (or on one rank)."""
    n = x.shape[axis]
    d = mesh.size("data")
    if n % d:
        return x
    m = n // d
    return x.narrow(axis, mesh.index("data") * m, m)


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the mesh's process group meets here (no-op without
    one)."""
    if mesh is not None and mesh.distributed:
        dist.barrier()


def shard_rows(mesh: Optional[Mesh], fn: Callable) -> Callable:
    """``fn(*batch)`` run data parallel: on this data rank's rows of every
    argument, its output's rows (a tensor, or a tuple, list or dict of
    tensors) gathered over ``data``, so every rank returns the whole
    batch's output (the JAX functions given a batch sharded with
    :func:`data_sharding`). A batch whose rows do not divide the data axis
    runs whole on every rank, as JAX runs it unsharded."""
    if mesh is None or not mesh.active("data"):
        return fn

    def run(*batch):
        if batch[0].shape[0] % mesh.size("data"):
            return fn(*batch)
        out = fn(*(data_sharding(mesh, x) for x in batch))
        if isinstance(out, dict):
            return {k: all_gather_rows(mesh, v) for k, v in out.items()}
        if isinstance(out, (tuple, list)):
            return type(out)(all_gather_rows(mesh, v) for v in out)
        return all_gather_rows(mesh, out)

    return run


def replicated(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> list:
    """Broadcast every tensor from rank 0 in place; returns them."""
    tensors = list(tensors)
    if mesh.distributed:
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tensors


# --- collectives over one axis -------------------------------------------------


def _staged(x: torch.Tensor, group) -> bool:
    """Whether the backend of ``group`` needs ``x`` staged through the
    host: gloo carrying a card's tensor."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    return x.cpu() if _staged(x, group) else x


def all_reduce(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor)."""
    if not mesh.active(axis):
        return x
    g = mesh.group(axis)
    w = _wire(x, g)
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=g)
    return w.to(x.device)


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str = "data", dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in
    coordinate order (equal shapes on every rank)."""
    if not mesh.active(axis):
        return x
    g = mesh.group(axis)
    w = _wire(x, g)
    parts = [torch.empty_like(w) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, w, group=g)
    return torch.cat(parts, dim=dim).to(x.device)


def _chunk(mesh: Mesh, x: torch.Tensor, axis: str, dim: int) -> int:
    """The size of one of ``axis``'s equal chunks of ``x`` along ``dim``."""
    n = mesh.size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} not divisible by mesh axis "
                         f"{axis!r} size {n}")
    return x.shape[dim] // n


def local_chunk(mesh: Mesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous chunk of ``x`` along ``dim`` (``axis``'s size
    chunks; the dimension must divide)."""
    m = _chunk(mesh, x, axis, dim)
    return x.narrow(dim, mesh.index(axis) * m, m).contiguous()


def reduce_scatter(mesh: Mesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over ``axis``."""
    if not mesh.active(axis):
        return local_chunk(mesh, x, axis, dim)
    g = mesh.group(axis)
    m = _chunk(mesh, x, axis, dim)
    parts = _wire(x.movedim(dim, 0), g)
    out = torch.empty((m, *parts.shape[1:]), dtype=parts.dtype, device=parts.device)
    dist.reduce_scatter_tensor(out, parts, op=dist.ReduceOp.SUM, group=g)
    return out.to(x.device).movedim(0, dim).contiguous()


def broadcast(mesh: Mesh, x: torch.Tensor, axis: str, src_index: int) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src_index`` along ``axis``, on
    every rank of the axis (the others pass a tensor of its shape)."""
    if not mesh.active(axis):
        return x
    g = mesh.group(axis)
    w = _wire(x, g)
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    dist.broadcast(w, src=mesh.peer(axis, src_index), group=g)
    return w.to(x.device)


def send(mesh: Mesh, x: torch.Tensor, axis: str, to_index: int) -> None:
    """Send ``x`` to the rank at coordinate ``to_index`` along ``axis``."""
    g = mesh.group(axis)
    dist.send(_wire(x, g), dst=mesh.peer(axis, to_index), group=g)


def recv(mesh: Mesh, like: torch.Tensor, axis: str, from_index: int) -> torch.Tensor:
    """A tensor shaped as ``like`` from the rank at ``from_index`` along
    ``axis``, on ``like``'s device."""
    g = mesh.group(axis)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _staged(like, g) else like.device)
    dist.recv(buf, src=mesh.peer(axis, from_index), group=g)
    return buf.to(like.device)


def exchange(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str, shift: int) -> list:
    """Send each tensor to coordinate ``index + shift`` along ``axis`` and
    receive the same shapes from ``index - shift`` (one
    ``batch_isend_irecv``: the JAX ``ppermute`` by ``shift``)."""
    if not mesh.active(axis):
        return list(tensors)
    g = mesh.group(axis)
    i = mesh.index(axis)
    to, frm = mesh.peer(axis, i + shift), mesh.peer(axis, i - shift)
    wires = [_wire(t, g) for t in tensors]
    bufs = [torch.empty_like(w) for w in wires]
    ops = [dist.P2POp(dist.isend, w, to, g) for w in wires]
    ops += [dist.P2POp(dist.irecv, b, frm, g) for b in bufs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(t.device) for b, t in zip(bufs, tensors)]


_OPS = {
    "identity": lambda mesh, x, axis, dim: x,
    "all_reduce": lambda mesh, x, axis, dim: all_reduce(mesh, x, axis),
    "all_gather": lambda mesh, x, axis, dim: all_gather(mesh, x, axis, dim),
    "reduce_scatter": lambda mesh, x, axis, dim: reduce_scatter(mesh, x, axis, dim),
    "split": lambda mesh, x, axis, dim: local_chunk(mesh, x, axis, dim),
}


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, fwd, bwd):
        ctx.args = (mesh, axis, dim, bwd)
        return _OPS[fwd](mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, bwd = ctx.args
        return _OPS[bwd](mesh, g.contiguous(), axis, dim), None, None, None, None, None


def collective(x: torch.Tensor, mesh: Mesh, axis: str, fwd: str, bwd: str,
               dim: int = 0) -> torch.Tensor:
    """``fwd`` of ``x`` over ``axis`` whose backward is ``bwd`` of the
    gradient: each one of "identity", "all_reduce", "all_gather",
    "reduce_scatter" or "split" (this rank's chunk), the last three along
    ``dim``. The Megatron pairs: ("identity", "all_reduce") at a
    column-parallel input, ("all_reduce", "identity") at a row-parallel
    output, ("all_gather", "reduce_scatter") into a sequence-parallel
    region, ("reduce_scatter", "all_gather") out of it, ("split",
    "all_gather") and ("all_gather", "split") around a region whose input
    and output are replicated."""
    return _Collective.apply(x, mesh, axis, dim, fwd, bwd)


# --- the data-parallel train step ---------------------------------------------


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` concatenated on dim 0 in rank order (no
    autograd); bool tensors travel as uint8."""
    if not mesh.active("data"):
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = all_gather(mesh, wire, "data")
    return out.bool() if x.dtype == torch.bool else out


def gather_with_local_grad(mesh: Mesh, z: torch.Tensor) -> torch.Tensor:
    """The global (B, ...) ``z`` from every data rank's rows, with this
    rank's own rows the autograd input: the gradient reaches the local rows
    only, and :func:`all_reduce_sum` of the parameter gradients then gives
    the single-device gradient of the global batch once (not ``size``
    times, as an autograd all-gather on top of that reduction would)."""
    if not mesh.active("data"):
        return z
    parts = list(all_gather_rows(mesh, z.detach()).chunk(mesh.size("data")))
    parts[mesh.index("data")] = z
    return torch.cat(parts)


def all_reduce_sum(mesh: Mesh, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The sum over the data axis of each gradient (one flat f32
    all-reduce). The ranks of another axis (``model``, ``stage``) hold
    gradients that are already whole or sharded, never partial sums of a
    data shard, so only the data axis reduces them."""
    if not mesh.active("data"):
        return grads
    names = list(grads)
    flat = all_reduce(mesh, torch.cat([grads[n].float().reshape(-1) for n in names]), "data")
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
