"""Non-causal multi-head attention for the Whisper encoder, the counterpart
of ``wealy_tpu.ops.flash_attention.flash_mha`` (a ``jax.custom_vjp``):

- forward: kernel K2 (``csrc/flash_attention.cu``);
- backward: kernels K5a (dQ) and K5b (dK, dV) (``csrc/flash_attention_bwd.cu``),
  which recompute the probabilities from the row log-sum-exp that K2
  writes when autograd needs it.

:func:`flash_mha` is a ``torch.autograd.Function`` when a gradient is
needed; under ``torch.no_grad()`` (extraction) it runs the forward alone
and saves nothing. Each wrapper takes the plain version for a CPU tensor
(:func:`_reference_mha` and its autograd, :func:`_reference_mha_grads`) and
launches its kernel for a CUDA tensor; the kernels take bf16 with head dim
64 (every published Whisper size) and any T >= 1, from 16-byte aligned
bases (their tiles arrive by TMA), and the wrappers raise on anything else.
"""

from __future__ import annotations

import torch

from wealy_tpu_torch import _build

HEAD_DIM = 64


def _reference_mha(q, k, v, scale: float):
    """f32 scores, f32 softmax, weights cast to the input dtype, f32 PV."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    w = torch.softmax(s * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)


def _reference_mha_grads(q, k, v, g, scale: float, wrt=(0, 1, 2)):
    """Autograd of :func:`_reference_mha` against cotangent g, the plain
    version of K5a/K5b (and the JAX package's non-TPU backward): the
    gradients of the inputs that ``wrt`` indexes in (q, k, v), (dq, dk, dv)
    by default."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(i in wrt) for i, t in enumerate((q, k, v))]
        out = _reference_mha(*leaves, scale)
        return torch.autograd.grad(out, [leaves[i] for i in wrt], g)


def _kernel_route(t: torch.Tensor) -> bool:
    """Every wrapper launches its kernel unless the tensor lies on the CPU."""
    return t.device.type != "cpu"


def _check(what: str, q, k, v, *more) -> None:
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    if (
        q.device.type != "cuda"
        or {t.device for t in (k, v, *more)} != {q.device}
        or {t.dtype for t in (q, k, v, *more)} != {torch.bfloat16}
        or Dh != HEAD_DIM
        or k.shape != (B, Tk, H, Dh)
        or v.shape != k.shape
        or any(t.shape != q.shape for t in more)
    ):
        raise ValueError(
            f"{what}: the kernel takes bf16 CUDA q/k/v of shape (B, T, H, 64) (and "
            f"g like q); got q {tuple(q.shape)} {q.dtype} {q.device}, k "
            f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} {v.dtype}"
            + "".join(f", {tuple(t.shape)} {t.dtype} {t.device}" for t in more)
        )


def _check_aligned(what: str, *tensors) -> None:
    """K2, K5a and K5b load tiles through TMA and write rows as 16-byte
    vectors: every base must lie on a 16-byte boundary (a fresh allocation
    does; a view at an offset may not)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the kernel needs 16-byte aligned q/k/v/g (TMA); got "
                         f"base addresses {[t.data_ptr() % 16 for t in tensors]} mod 16")


def _launch_fwd(q, k, v, scale: float, with_lse: bool):
    """K2: (out, lse f32 (B, H, Tq) or None)."""
    _check("flash_mha", q, k, v)
    B, Tq, H, Dh = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_aligned("flash_mha", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) if with_lse else None
    _build.check(
        _build.library().wealy_flash_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Tq, k.shape[1], H, Dh, float(scale), _build.stream(q.device),
        ),
        "flash_mha",
    )
    flash_mha.launches += 1
    return out, lse


def _launch_dq(q, k, v, g, lse, scale: float):
    """K5a: (dq, delta f32 (B, H, Tq))."""
    _check("flash_mha_bwd_dq", q, k, v, g)
    B, Tq, H, Dh = q.shape
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    _check_aligned("flash_mha_bwd_dq", q, k, v, g)
    lse = lse.float().contiguous()
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _build.check(
        _build.library().wealy_flash_mha_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            B, Tq, k.shape[1], H, Dh, float(scale), _build.stream(q.device),
        ),
        "flash_mha_bwd_dq",
    )
    flash_mha_bwd_dq.launches += 1
    return dq, delta


def _launch_dkv(q, k, v, g, lse, delta, scale: float):
    """K5b: (dk, dv)."""
    _check("flash_mha_bwd_dkv", q, k, v, g)
    B, Tq, H, Dh = q.shape
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    _check_aligned("flash_mha_bwd_dkv", q, k, v, g)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.check(
        _build.library().wealy_flash_mha_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Tq, k.shape[1], H, Dh, float(scale), _build.stream(q.device),
        ),
        "flash_mha_bwd_dkv",
    )
    flash_mha_bwd_dkv.launches += 1
    return dk, dv


def flash_mha_fwd(q, k, v, scale: float, with_lse: bool = False):
    """(out, lse): the forward, with the row log-sum-exp of the scaled
    scores (f32 (B, H, Tq)) when ``with_lse`` and the kernel runs; lse is
    None on the CPU (its backward needs none)."""
    if not _kernel_route(q):
        return _reference_mha(q, k, v, scale), None
    return _launch_fwd(q, k, v, scale, with_lse)


def _reference_delta(q, k, v, g, scale: float):
    """rowsum(p * dp) in f32 (B, H, Tq), as the TPU kernels sum it: p the
    f32 softmax of the scaled scores, dp = g . v^T in f32."""
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    return (p * dp).sum(-1)


def flash_mha_bwd_dq(q, k, v, g, lse, scale: float):
    """K5a: (dq, delta), delta = rowsum(p * dp) in f32 (B, H, Tq) over every
    key (K5a does not read the forward's output)."""
    if not _kernel_route(q):
        delta = _reference_delta(q, k, v, g, scale)
        return _reference_mha_grads(q, k, v, g, scale, wrt=(0,))[0], delta
    return _launch_dq(q, k, v, g, lse, scale)


def flash_mha_bwd_dkv(q, k, v, g, lse, delta, scale: float):
    """K5b: (dk, dv), reading the delta that K5a wrote."""
    if not _kernel_route(q):
        return _reference_mha_grads(q, k, v, g, scale, wrt=(1, 2))
    return _launch_dkv(q, k, v, g, lse, delta, scale)


class _FlashMHA(torch.autograd.Function):
    """K2 forward (with lse), K5a + K5b backward; the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_mha_fwd(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lse = ctx.saved_tensors
        dq, delta = flash_mha_bwd_dq(q, k, v, g, lse, ctx.scale)
        dk, dv = flash_mha_bwd_dkv(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_mha(q, k, v, scale: float):
    """q (B, Tq, H, Dh), k/v (B, Tk, H, Dh) -> (B, Tq, H, Dh).

    ``scale`` multiplies the raw q.k logits (pass Dh**-0.5). Differentiable
    in q, k and v.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashMHA.apply(q, k, v, scale)
    return flash_mha_fwd(q, k, v, scale)[0]


flash_mha.launches = 0
flash_mha_bwd_dq.launches = 0
flash_mha_bwd_dkv.launches = 0
