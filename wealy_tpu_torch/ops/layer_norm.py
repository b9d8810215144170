"""Row-wise LayerNorm over the last axis: kernel K6 (``csrc/layer_norm.cu``),
replacing the TPU kernel ``wealy_tpu/ops/layer_norm.py:26`` ``_ln_kernel``
(public ``fused_layer_norm``).

:func:`fused_layer_norm` is a ``torch.autograd.Function``: its forward takes
the plain version :func:`_reference_ln` for a CPU tensor and launches the
kernel for a CUDA tensor (bf16 or f32 ``x``, f32 ``scale`` and ``bias`` of
shape (D,)), raising on anything else; its backward is autograd of
:func:`_reference_ln` on the saved inputs, as the JAX ``custom_vjp``'s
``_bwd`` (``layer_norm.py:82-85``): the JAX package has no backward kernel,
so neither has the port. The kernel takes any row count; the TPU wrapper's
padding of rows to ``ROW_BLOCK`` has no counterpart.

What bounds it on an H100: device memory. It reads each row once and
writes it once (at (64, 1500, 384) bf16, 147 MB, about 44 us at 3.35
TB/s) and does about 8 operations per element. The kernel keeps a row in
registers (the row route: a persistent grid, a few lanes a row, 16-byte
streaming loads, the next rows' loads in flight during this row's
reductions, scale and bias held in registers) or, for rows too wide for a
lane's registers, in shared memory (the block route: a block a row), so
nothing but x and the output crosses device memory. :func:`launch_plan`
picks the route and the split of a row over lanes; the kernel takes
1 <= D <= ``MAX_D``.

:func:`fused_add_layer_norm` is K6's second entry: ``(s, h)`` with ``s = x +
y`` (the residual add, rounded once to x's dtype as PyTorch's ``x + y``) and
``h`` the LayerNorm of ``s``, in one pass over the rows on the same routes
(8 bytes an element in bf16 where ``x + y`` then :func:`fused_layer_norm`
move 10). The Whisper blocks fuse each residual add with the LayerNorm that
reads its sum this way. Its plain version is ``_reference_ln(x + y)``. It
has no JAX counterpart, and its backward differentiates the same function
through ATen's f32 LayerNorm (:func:`_aten_add_ln`): one fused backward
kernel, where autograd of ``_reference_ln`` runs some twenty elementwise
passes over f32 copies of the stream. The plain entry keeps the JAX
backward: its tests hold its gradients within 1e-5 relative and 1e-6
absolute of the plain version's, which ATen's reduction order misses in
the scale and bias gradients. :func:`takes` is the route a caller chooses from
the input alone: the kernel for a CUDA tensor in bf16 or f32 with D <=
``MAX_D``. ``fused_layer_norm.launches`` counts K6's launches by either
entry, ``fused_add_layer_norm.launches`` the fused entry's.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from wealy_tpu_torch import _build

# tests/test_layer_norm.py's bounds against the plain version
F32_TOL = 1e-5  # rtol and atol, f32 input (:18)
BF16_TOL = 2e-2  # rtol and atol, bf16 output (:29)
# the launch plan's limits, as csrc/layer_norm.cu's constants
MAX_D = 32768  # kMaxD: the block route stages a row of up to 128 KB (f32) in shared memory
ROW_VALUES = 40  # kRowValues: a lane's values on the row route
BLOCK_THREADS = 256  # kBlockThreads: a block's threads on the block route
ROW, BLOCK = 0, 1  # the routes
# accesses a lane that the row route is built for, by values an access
# (16 bytes of bf16, of f32, or one element)
ROW_ACCESSES = {8: tuple(range(1, ROW_VALUES // 8 + 1)), 4: tuple(range(1, ROW_VALUES // 4 + 1)),
                1: (1, 2, 4, 8, 16, 24)}


def launch_plan(D: int, bf16: bool, aligned: bool) -> tuple[int, int, int, int]:
    """(route, vec, lanes, per_lane) of K6 for rows of width D: ``vec``
    values an access (16 bytes where ``aligned``, meaning x, the output,
    scale and bias all start on a 16-byte boundary, and D divides; else
    1). The row route takes an even split of the row's accesses, ``lanes``
    (a power of 2 up to 32) times ``per_lane``, within ``ROW_VALUES`` values
    a lane; a width that no such split covers takes one element an access,
    ``lanes`` x ``per_lane`` covering D with the last accesses guarded;
    wider rows take the block route (``lanes`` is then the block's
    threads, ``per_lane`` the accesses each takes)."""
    epv = 8 if bf16 else 4
    vec = epv if aligned and D % epv == 0 else 1
    if vec > 1:
        n = D // vec
        lanes = min(32, n & -n)
        if n // lanes * vec <= ROW_VALUES:
            return ROW, vec, lanes, n // lanes
    if D <= 32 * ROW_ACCESSES[1][-1]:
        lanes = min(32, 1 << (D - 1).bit_length())
        need = -(-D // lanes)
        return ROW, 1, lanes, next(a for a in ROW_ACCESSES[1] if a >= need)
    return BLOCK, vec, BLOCK_THREADS, -(-(D // vec) // BLOCK_THREADS)


def _reference_ln(x, scale, bias, eps: float):
    """f32 mean and biased variance over the last axis, rsqrt(var + eps),
    the affine transform in f32, the result in x's dtype
    (``layer_norm.py:36-41``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _kernel_route(t: torch.Tensor) -> bool:
    """The wrapper launches the kernel unless the tensor lies on the CPU."""
    return t.device.type != "cpu"


def takes(x: torch.Tensor) -> bool:
    """Whether K6 takes rows ``x`` (..., D): a CUDA tensor in bf16 or f32
    with 1 <= D <= ``MAX_D``. Elsewhere a caller runs the plain version."""
    return (x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float32)
            and x.dim() > 0 and 1 <= x.shape[-1] <= MAX_D)


def _rows(name: str, x, scale, bias, *more):
    """x and ``more`` (each x's shape, dtype and device) as contiguous
    (rows, D), with contiguous scale and bias; raises on what K6 does not
    take."""
    D = x.shape[-1] if x.dim() else 0
    if (
        x.device.type != "cuda"
        or {scale.device, bias.device} != {x.device}
        or x.dtype not in (torch.bfloat16, torch.float32)
        or {scale.dtype, bias.dtype} != {torch.float32}
        or scale.shape != (D,)
        or bias.shape != (D,)
        or not 1 <= D <= MAX_D
        or any((t.shape, t.dtype, t.device) != (x.shape, x.dtype, x.device) for t in more)
    ):
        raise ValueError(
            f"{name}: the kernel takes bf16 or f32 CUDA x (..., D) with 1 <= D <= {MAX_D}"
            + (", y of x's shape, dtype and device" if more else "")
            + " and f32 scale, bias (D,) on the same device; got x "
            f"{tuple(x.shape)} {x.dtype} {x.device}, "
            + "".join(f"y {tuple(t.shape)} {t.dtype} {t.device}, " for t in more)
            + f"scale {tuple(scale.shape)} {scale.dtype} {scale.device}, bias "
            f"{tuple(bias.shape)} {bias.dtype} {bias.device}"
        )
    return ([t.reshape(-1, D).contiguous() for t in (x, *more)], scale.contiguous(),
            bias.contiguous())


def _plan(D: int, bf16: bool, *tensors) -> tuple[int, int, int, int]:
    """:func:`launch_plan` at the tensors' addresses: 16-byte accesses only
    where every one starts on a 16-byte boundary."""
    return launch_plan(D, bf16, all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch_ln(x, scale, bias, eps: float):
    """K6 on (..., D) CUDA x."""
    (xr,), scale, bias = _rows("fused_layer_norm", x, scale, bias)
    out = torch.empty_like(xr)
    if xr.shape[0]:
        D, bf16 = xr.shape[1], x.dtype == torch.bfloat16
        _build.check(
            _build.library().wealy_layer_norm(
                xr.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                xr.shape[0], D, int(bf16), float(eps), *_plan(D, bf16, xr, out, scale, bias),
                _build.stream(x.device),
            ),
            "fused_layer_norm",
        )
        fused_layer_norm.launches += 1
    return out.reshape(x.shape)


def _launch_add_ln(x, y, scale, bias, eps: float):
    """K6's fused entry on (..., D) CUDA x and y: (x + y, its LayerNorm)."""
    (xr, yr), scale, bias = _rows("fused_add_layer_norm", x, scale, bias, y)
    s, out = torch.empty_like(xr), torch.empty_like(xr)
    if xr.shape[0]:
        D, bf16 = xr.shape[1], x.dtype == torch.bfloat16
        _build.check(
            _build.library().wealy_add_layer_norm(
                xr.data_ptr(), yr.data_ptr(), scale.data_ptr(), bias.data_ptr(), s.data_ptr(),
                out.data_ptr(), xr.shape[0], D, int(bf16), float(eps),
                *_plan(D, bf16, xr, yr, s, out, scale, bias), _build.stream(x.device),
            ),
            "fused_add_layer_norm",
        )
        fused_layer_norm.launches += 1
        fused_add_layer_norm.launches += 1
    return s.reshape(x.shape), out.reshape(x.shape)


def _reference_add_ln(x, y, scale, bias, eps: float):
    """The fused entry's plain version: (x + y, _reference_ln(x + y))."""
    s = x + y
    return s, _reference_ln(s, scale, bias, eps)


def _aten_ln(x, scale, bias, eps: float):
    """ATen's LayerNorm on x's f32 upcast, in x's dtype: _reference_ln's
    function, with one fused backward kernel."""
    return F.layer_norm(x.float(), x.shape[-1:], scale, bias, eps).to(x.dtype)


def _aten_add_ln(x, y, scale, bias, eps: float):
    """(x + y, _aten_ln(x + y)): what the fused entry's backward
    differentiates."""
    s = x + y
    return s, _aten_ln(s, scale, bias, eps)


def _ln_fwd(x, scale, bias, eps: float = 1e-5):
    """The forward alone: K6, or the plain version for a CPU tensor."""
    if not _kernel_route(x):
        return _reference_ln(x, scale, bias, eps)
    return _launch_ln(x, scale, bias, eps)


def _backward(ctx, fn, *g):
    """The input gradients of ``fn(*saved inputs, eps)`` against the output
    gradients ``g``: autograd on the saved inputs, one gradient a
    differentiable input (None where none is needed), None for eps."""
    need = ctx.needs_input_grad[:-1]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        outs = fn(*leaves, ctx.eps)
        grads = iter(torch.autograd.grad(outs, [t for t in leaves if t.requires_grad], g))
    return (*(next(grads) if n else None for n in need), None)


class _FusedLayerNorm(torch.autograd.Function):
    """K6 forward; backward = autograd of _reference_ln on the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _ln_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, _reference_ln, g)


def fused_layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis: f32 statistics, output in x's dtype;
    differentiable in x, scale and bias."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return _FusedLayerNorm.apply(x, scale, bias, eps)
    return _ln_fwd(x, scale, bias, eps)


fused_layer_norm.launches = 0


def _add_ln_fwd(x, y, scale, bias, eps: float = 1e-5):
    """The fused entry's forward alone: K6, or the plain version for a CPU
    tensor."""
    if not _kernel_route(x):
        return _reference_add_ln(x, y, scale, bias, eps)
    return _launch_add_ln(x, y, scale, bias, eps)


class _FusedAddLayerNorm(torch.autograd.Function):
    """K6's fused forward; backward = autograd of _aten_add_ln on the saved
    inputs."""

    @staticmethod
    def forward(ctx, x, y, scale, bias, eps):
        ctx.save_for_backward(x, y, scale, bias)
        ctx.eps = eps
        return _add_ln_fwd(x, y, scale, bias, eps)

    @staticmethod
    def backward(ctx, g_s, g_h):
        return _backward(ctx, _aten_add_ln, g_s, g_h)


def fused_add_layer_norm(x, y, scale, bias, eps: float = 1e-5):
    """``(s, h)``: the residual add ``s = x + y`` in x's dtype (f32 sum, one
    rounding) and ``h``, the LayerNorm of ``s`` over the last axis (f32
    statistics and affine, one rounding to x's dtype), in one K6 pass on the
    card; differentiable in x, y, scale and bias."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, y, scale, bias)):
        return _FusedAddLayerNorm.apply(x, y, scale, bias, eps)
    return _add_ln_fwd(x, y, scale, bias, eps)


fused_add_layer_norm.launches = 0
