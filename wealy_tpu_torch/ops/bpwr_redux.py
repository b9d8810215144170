"""Chunk-set ``bpwr`` reduction over a (Q, B, s1, s2) block: kernel K4
(``csrc/bpwr_redux.cu``), replacing the TPU kernel
``wealy_tpu/ops/pallas_redux.py:67`` ``_bpwr_kernel`` (public
``bpwr_block_redux``).

:func:`bpwr_block_redux` takes the plain version (``distance_tensor_redux``
with the exclusion mask, whose bpwr branch is ``ops/redux.py::_bpwr``) for a
CPU tensor and launches the kernel for a CUDA tensor. The kernel reads ``d``
through its strides (the transposed view of the distance matrix needs no
copy) and the validity masks in place, and gives the plain version's bits.
It takes f32 tiles of any size, as the JAX function scores any tile: the
kernel picks its route by shape (:data:`ROUTES`, :func:`kernel_route`). The
wrapper raises on anything else, and never takes the plain path for a CUDA
tensor.

What bounds it on an H100: one f32 read of each tile from device memory
against n dependent knockout rounds per pair, so the rounds, not the read,
set its time. Tiles of at most 32 x 32 chunks (every product shape) run
one lane per row, column liveness as bitmasks ORed across the lanes: each
lane sorts its row once and steps through it as columns die. Any other tile
runs one block per pair, from shared memory where the tile fits and from
device memory beyond. The plain version
instead makes n round trips of the whole tensor through device memory.
"""

from __future__ import annotations

import torch

from wealy_tpu_torch import _build
from wealy_tpu_torch.ops.redux import distance_tensor_redux

# the routes of csrc/bpwr_redux.cu, in the order wealy_bpwr_route numbers them
ROUTES = ("sorted", "block, tile in shared memory", "block, tile in device memory")
INF = 1e12  # distance_tensor_redux's mask fill
EPS = 1e-7


def _reference_bpwr_block(d, qvalid, cvalid, redux: str, eps: float, inf: float):
    excl = (~qvalid)[:, None, :, None] | (~cvalid)[None, :, None, :]
    return distance_tensor_redux(d, redux, mask=excl.expand(d.shape), eps=eps, inf=inf)


def bpwr_block_redux(d, qvalid, cvalid, redux: str = "bpwr", *, eps: float = EPS,
                     inf: float = INF):
    """``distance_tensor_redux(d, "bpwr[-n]")`` with the exclusions of
    invalid chunks.

    d: (Q, B, s1, s2) segment distances; qvalid (Q, s1) and cvalid (B, s2)
    bool, True = valid chunk. Returns (Q, B) float32.
    """
    if redux.split("-")[0] != "bpwr":
        raise ValueError(f"bpwr_block_redux: not a bpwr mode: {redux!r}")
    Q, B, s1, s2 = d.shape
    n_req = s1 if "-" not in redux else int(redux.split("-")[-1])
    if d.device.type == "cpu":
        return _reference_bpwr_block(d, qvalid, cvalid, redux, eps, inf)
    if (
        d.device.type != "cuda"
        or {qvalid.device, cvalid.device} != {d.device}
        or d.dtype != torch.float32
        or qvalid.dtype != torch.bool
        or cvalid.dtype != torch.bool
        or qvalid.shape != (Q, s1)
        or cvalid.shape != (B, s2)
        or min(s1, s2) < 1
    ):
        raise ValueError(
            "bpwr_block_redux: the kernel takes f32 CUDA d (Q, B, s1, s2) with "
            "s1, s2 >= 1 and bool qvalid (Q, s1), cvalid (B, s2) on the "
            f"same device; got d {tuple(d.shape)} {d.dtype} {d.device}, qvalid "
            f"{tuple(qvalid.shape)} {qvalid.dtype} {qvalid.device}, cvalid "
            f"{tuple(cvalid.shape)} {cvalid.dtype} {cvalid.device}"
        )
    out = torch.empty((Q, B), dtype=torch.float32, device=d.device)
    if Q * B == 0:
        return out
    qvalid, cvalid = qvalid.contiguous(), cvalid.contiguous()
    n = max(1, min(n_req, min(s1, s2)))
    lib = _build.library()
    _build.check(
        lib.wealy_bpwr_redux(
            d.data_ptr(), qvalid.data_ptr(), cvalid.data_ptr(), out.data_ptr(),
            Q, B, s1, s2, *d.stride(), n, float(eps), float(inf), _build.stream(d.device),
        ),
        "bpwr_block_redux",
    )
    bpwr_block_redux.launches += 1
    return out


bpwr_block_redux.launches = 0


def kernel_route(s1: int, s2: int) -> str:
    """The route K4 takes for an s1 x s2 tile on the current card (one of
    :data:`ROUTES`); the block route's two depend on the card's shared
    memory."""
    return ROUTES[_build.library().wealy_bpwr_route(int(s1), int(s2))]
