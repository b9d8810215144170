"""Chunk-set ``bpwr`` reduction over a (Q, B, s1, s2) block: kernel K4
(``csrc/bpwr_redux.cu``), replacing the TPU kernel
``wealy_tpu/ops/pallas_redux.py:67`` ``_bpwr_kernel`` (public
``bpwr_block_redux``).

:func:`bpwr_block_redux` takes the plain version (``distance_tensor_redux``
with the exclusion mask, whose bpwr branch is ``ops/redux.py::_bpwr``) for a
CPU tensor and launches the kernel for a CUDA tensor. The kernel reads ``d``
through its strides (the transposed view of the distance matrix needs no
copy) and the validity masks in place, and gives the plain version's bits.
It takes f32 tiles with both sides at most :data:`MAX_SIDE`; the wrapper
raises on anything else, and never takes the plain path for a CUDA tensor.

What bounds it on an H100: one f32 read of each tile from device memory
against about n * s1 * s2 compares per pair, which run from shared memory,
so the knockout rounds, not the read, set its time. The design keeps the
tile in shared memory for all n rounds (one warp per pair), where the plain
version makes n round trips of the whole tensor through device memory.
"""

from __future__ import annotations

import torch

from wealy_tpu_torch import _build
from wealy_tpu_torch.ops.redux import distance_tensor_redux

MAX_SIDE = 128  # kMaxSide in csrc/bpwr_redux.cu: chunks per song on either side
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
        or max(s1, s2) > MAX_SIDE
    ):
        raise ValueError(
            "bpwr_block_redux: the kernel takes f32 CUDA d (Q, B, s1, s2) with "
            f"1 <= s1, s2 <= {MAX_SIDE} and bool qvalid (Q, s1), cvalid (B, s2) on the "
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
