"""Pipeline parallelism for the Whisper encoder (GPipe over a ``stage``
axis), the counterpart of ``wealy_tpu.parallel.pp``.

TP (``tp.py``) splits the width of every layer over ranks; pipeline
parallelism splits the depth: stage s runs blocks ``[s·L/S, (s+1)·L/S)`` of
``encoder.blocks``, the batch goes through in ``n_micro`` microbatches,
and after each microbatch a stage hands one (mb, T, D) activation to the
next (``send`` / ``recv`` on the mesh's ``stage`` axis). Stage s starts
microbatch m as soon as stage s - 1 has finished it, so at steady state
every stage works on a different microbatch: the GPipe schedule of ``M + S
- 1`` steps for ``M`` microbatches over ``S`` stages. The conv stem and
``ln_post`` are replicated (each about one layer's cost); the last stage's
outputs are broadcast to every stage.

Differentiable, with the GPipe backward: the forward keeps each
microbatch's graph of the stage's blocks; the backward walks the
microbatches in reverse, receiving each output gradient from the next stage
and sending the input gradient to the previous one. Every rank then holds
the single-rank encoder's gradient: the block gradients (each non-zero on
its own stage) and the stem's input gradient (non-zero on stage 0) are
summed over ``stage`` in one flat all-reduce, as the transpose of the JAX
``shard_map`` assembles the global gradient.

Composes with data parallelism on a (``data``, ``stage``) mesh: each data
rank's rows are pipelined over its stage line. The returned function takes
the global batch; its ``local`` attribute takes this data rank's rows (the
train step's ``model_call``, which is handed the local rows).

The port has no scan layout (the JAX pipeline slices the stacked layer axis
of a ``scan_layers`` encoder and refuses an unrolled one); every rank holds
the whole encoder module and runs its stage's blocks, so a JAX scanned
checkpoint converts through ``models/whisper/convert.py::
state_dict_from_jax_params`` like an unrolled one.
"""

from __future__ import annotations

import torch
from torch import nn

from wealy_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    broadcast,
    make_mesh,
    recv,
    send,
    shard_rows,
)


def make_pp_mesh(n_stage: int, n_data: int = 1, device=None) -> Mesh:
    """(data, stage) mesh of the process group, ``stage`` innermost (the
    per-step activation goes to a neighbouring rank)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_data * n_stage != world:
        raise ValueError(f"(data={n_data}, stage={n_stage}) does not hold {world} rank(s)")
    return make_mesh(("data", "stage"), (n_data, n_stage), device=device)


class _Schedule:
    """One stage's GPipe schedule: its blocks, the microbatch count and the
    graphs the forward keeps for the backward."""

    def __init__(self, encoder: nn.Module, mesh: Mesh, n_micro: int):
        self.mesh = mesh
        self.S = mesh.size("stage")
        self.s = mesh.index("stage")
        per = len(encoder.blocks) // self.S
        self.blocks = encoder.blocks[self.s * per : (self.s + 1) * per]
        self.local_params = [p for b in self.blocks for p in b.parameters()]
        self.all_params = [p for b in encoder.blocks for p in b.parameters()]
        self.M = n_micro

    def run_blocks(self, x):
        from wealy_tpu_torch.models.whisper.model import run_blocks

        return run_blocks(self.blocks, x)[0]

    def forward(self, x0: torch.Tensor, keep: bool):
        mesh, S, s = self.mesh, self.S, self.s
        micro = x0.chunk(self.M)
        graphs, outs = [], []
        for m in range(self.M):
            x = micro[m] if s == 0 else recv(mesh, micro[m], "stage", s - 1)
            x = x.detach().requires_grad_(keep)
            with torch.set_grad_enabled(keep):
                y = self.run_blocks(x)
            if s < S - 1:
                send(mesh, y.detach(), "stage", s + 1)
            else:
                outs.append(y.detach())
            if keep:
                graphs.append((x, y))
        out = torch.cat(outs) if s == S - 1 else torch.empty_like(x0)
        return broadcast(mesh, out, "stage", S - 1), graphs

    def backward(self, graphs, g_out: torch.Tensor):
        mesh, S, s = self.mesh, self.S, self.s
        g_micro = g_out.chunk(self.M)
        acc = {id(p): torch.zeros_like(p) for p in self.local_params}
        gx = [None] * self.M
        for m in reversed(range(self.M)):
            x, y = graphs[m]
            g = g_micro[m] if s == S - 1 else recv(mesh, y, "stage", s + 1)
            grads = torch.autograd.grad(y, [x, *self.local_params], g, allow_unused=True)
            if s > 0:
                send(mesh, grads[0], "stage", s - 1)
            else:
                gx[m] = grads[0]
            for p, gp in zip(self.local_params, grads[1:]):
                if gp is not None:
                    acc[id(p)] += gp
        gx0 = torch.cat(gx) if s == 0 else torch.zeros_like(g_out)
        parts = [gx0, *(acc.get(id(p), torch.zeros_like(p)) for p in self.all_params)]
        flat = all_reduce(mesh, torch.cat([t.float().reshape(-1) for t in parts]), "stage")
        out, offset = [], 0
        for t in parts:
            out.append(flat[offset : offset + t.numel()].view(t.shape).to(t.dtype))
            offset += t.numel()
        return out[0], out[1:]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, schedule, keep, *params):
        out, graphs = schedule.forward(x0, keep)
        ctx.schedule, ctx.graphs = schedule, graphs
        return out

    @staticmethod
    def backward(ctx, g_out):
        gx0, gparams = ctx.schedule.backward(ctx.graphs, g_out.contiguous())
        ctx.graphs = None
        return (gx0, None, None, *gparams)


def pp_encode_fn(encoder: nn.Module, mesh: Mesh, n_micro: int = 4):
    """``encode(mel) -> (B, T, D)``: the pipelined ``encoder`` (a
    ``WhisperEncoder``, or a ``Whisper``'s encoder) over the mesh's
    ``stage`` axis, the global batch sharded over ``data`` and gathered
    back. ``encode.local(rows)`` pipelines this data rank's rows and
    returns their states (differentiable). The layer count must divide by
    the stage count (checked here) and each data rank's batch by
    ``n_micro`` (checked at the call). Equal to the single-rank encoder
    (the same blocks on the same rows), and so are its gradients."""
    from wealy_tpu_torch.models.whisper.model import _ln

    encoder = getattr(encoder, "encoder", encoder)
    S, L = mesh.size("stage"), len(encoder.blocks)
    if L % S:
        raise ValueError(f"n_audio_layer={L} not divisible by {S} stages")
    schedule = _Schedule(encoder, mesh, n_micro)

    def local(mel: torch.Tensor) -> torch.Tensor:
        x0 = encoder.stem(mel.to(mesh.device))
        if x0.shape[0] % n_micro:
            raise ValueError(f"batch {x0.shape[0]} not divisible by n_micro={n_micro}")
        keep = torch.is_grad_enabled() and (
            x0.requires_grad or any(p.requires_grad for p in schedule.all_params))
        out = _Pipeline.apply(x0, schedule, keep, *schedule.all_params)
        return _ln(encoder.ln_post, out)

    encode = shard_rows(mesh, local)
    encode.local = local
    return encode

