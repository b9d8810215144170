"""Ring attention: exact context parallelism over a mesh axis, the
counterpart of ``wealy_tpu.parallel.ring``.

The time axis of q/k/v is split over the ranks of an axis (``cp``): each
rank keeps its query block, and the K/V blocks (and the key mask) go round
the ring, one rank on per step (``exchange``, one ``batch_isend_irecv``),
while a flash-style online softmax accumulates the exact result. The full
(T, T) score matrix exists on no rank; per step the only traffic is one
K/V block. The recurrence runs in f32 whatever the inputs' dtype: masked
scores are set to -1e30 (a finite floor keeps the running max finite where
a whole rotated block is padding), masked probabilities are zeroed again,
and the output is divided by ``max(l, 1e-30)``.

Differentiable: the rotation is an autograd operator whose backward sends
the K/V gradients the other way round the ring, so each block's gradient
returns to its rank. The JAX ring is plain XLA, not Pallas, and so is this
one: K2 takes neither f32 inputs nor a key mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from wealy_tpu_torch.parallel.mesh import Mesh, collective, exchange, local_chunk, make_mesh

_NEG_BIG = -1e30


def make_cp_mesh(n_cp: int, n_data: int = 1, device=None) -> Mesh:
    """A (data, cp) mesh: batch rows shard over ``data``, the sequence over
    ``cp``. With ``n_data=1`` this is a pure ring."""
    return make_mesh(("data", "cp"), (n_data, n_cp), device=device)


class _Rotate(torch.autograd.Function):
    """K, V and the key mask one rank on round the ring; the backward sends
    the K and V gradients one rank back."""

    @staticmethod
    def forward(ctx, k, v, mask, mesh, axis):
        ctx.args = (mesh, axis)
        k, v, m = exchange(mesh, [k, v, mask.to(torch.uint8)], axis, 1)
        m = m.bool()
        ctx.mark_non_differentiable(m)
        return k, v, m

    @staticmethod
    def backward(ctx, gk, gv, gm):
        mesh, axis = ctx.args
        gk, gv = exchange(mesh, [gk.contiguous(), gv.contiguous()], axis, -1)
        return gk, gv, None, None, None


def _ring_body(q, k, v, mask, scale: float, mesh: Mesh, axis: str):
    """One rank's ring: q (B, Tq, H, D) resident, k/v (B, Tk, H, D) and
    mask (B, Tk) True=valid rotating; f32 accumulation."""
    b, tq, h, d = q.shape
    qf = q.float() * scale
    m_run = torch.full((b, h, tq), _NEG_BIG, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    n = mesh.size(axis)
    for step in range(n):
        valid = mask[:, None, None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
        s = torch.where(valid, s, _NEG_BIG)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        # masked columns underflow to 0 wherever a valid one exists; zeroed
        # again so a wholly masked block adds nothing when m_new is the floor
        p = torch.where(valid, p, 0.0)
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
        m_run = m_new
        if step < n - 1:  # the last block needs no further hop
            k, v, mask = _Rotate.apply(k, v, mask, mesh, axis)
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mesh: Mesh,
                   axis: str = "cp", kv_mask: Optional[torch.Tensor] = None,
                   data_axis: Optional[str] = "data") -> torch.Tensor:
    """Exact multi-head attention with the sequence split over ``axis``.
    q/k/v: (B, T, H, D) global tensors, the same on every rank (T divisible
    by the axis size: pad and pass ``kv_mask``); kv_mask: optional (B, T)
    bool, True=valid. If ``data_axis`` names a mesh axis, the batch also
    shards over it (cp composed with dp). Returns the global (B, T, H, D)
    output on every rank; its gradient reaches q/k/v whole on every rank."""
    n = mesh.size(axis)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]}/{k.shape[1]} not divisible by mesh axis "
                         f"{axis!r} size {n}; pad and pass kv_mask")
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    dp = data_axis if data_axis in mesh.axis_names and mesh.size(data_axis) > 1 else None

    def local(x):
        x = collective(x.to(mesh.device), mesh, axis, "split", "all_gather", dim=1)
        return x if dp is None else collective(x, mesh, dp, "split", "all_gather", dim=0)

    mask = local_chunk(mesh, kv_mask.to(mesh.device), axis, 1)
    if dp is not None:
        mask = local_chunk(mesh, mask, dp, 0)
    out = _ring_body(local(q), local(k), local(v), mask, scale, mesh, axis)
    out = collective(out, mesh, axis, "all_gather", "split", dim=1)
    return out if dp is None else collective(out, mesh, dp, "all_gather", "split", dim=0)
