"""The numeric ops of the port: the kernels' wrappers (``log_mel`` lives in
``audio/``; here fused attention K2 with its backward K5a/K5b, the fused MLP
K3, LayerNorm K6, the chunk-set scorer K4, and the decoder step's decode
attention, which has no TPU counterpart) and the plain torch equivalents of
the reference's lib/tensor_ops.py, exported here as ``wealy_tpu.ops``
exports them. Mask convention of the masked ops: True = excluded (the
layers' opposite convention converts through ``utils/masks.py``). Below,
the tolerances that hold K2, K3 and K5 against their plain versions."""

from __future__ import annotations

import torch

from wealy_tpu_torch.ops.masked import mbest, mmax, mmean, mmin, mrand, msum, mworst
from wealy_tpu_torch.ops.distance import (
    pairwise_distance_matrix,
    pairwise_euclidean_distance_matrix,
)
from wealy_tpu_torch.ops.framing import force_length, frames, get_frames
from wealy_tpu_torch.ops.redux import distance_tensor_redux
from wealy_tpu_torch.ops.misc import check_finite, covariance, roughly_equal, tensor_quantile

__all__ = [
    "msum", "mmean", "mmin", "mmax", "mrand", "mbest", "mworst",
    "pairwise_euclidean_distance_matrix", "pairwise_distance_matrix",
    "force_length", "frames", "get_frames", "distance_tensor_redux",
    "tensor_quantile", "covariance", "roughly_equal", "check_finite",
    "BF16_COS_MIN", "BF16_REL_ABS", "BF16_GRAD_COS_MIN", "NOISE_ROW_FLOOR", "bf16_agreement",
]

# How close K2 and K3 must come to their plain versions: bf16 outputs whose
# sums run in another order, so a per-row cosine and a max-abs bound relative
# to the output's scale (one bf16 ulp is 2**-8 relative)
BF16_COS_MIN = 0.9999
BF16_REL_ABS = 2e-2
# K5a/K5b (the attention backward) against autograd of the plain attention:
# both round p and ds (the plain version dp too) to bf16 before products,
# at other places, and ds = p * (dp - delta) cancels, so rows agree less
BF16_GRAD_COS_MIN = 0.999
# In a row whose softmax is nearly one-hot, dq = ds . k is a cancellation
# (the row of ds sums to 0) that can fall far below the rounding of its
# terms: ds rounded to bf16 before the product, as the TPU kernel rounds it,
# leaves only rounding there, in any order of adds. Rows whose reference
# norm is below this share of the RMS row norm are held by the max-abs bound
# alone (chip_smoke.py phase 12 on an H100, (4, 1500, 6) with q and k scaled
# 3.7x: 1,993 of 36,000 dq rows)
NOISE_ROW_FLOOR = 1e-4


def bf16_agreement(got: torch.Tensor, want: torch.Tensor, cos_min: float = BF16_COS_MIN,
                   row_floor: float = 0.0) -> tuple[bool, float, float]:
    """(within the bound, max |got - want|, smallest per-row cosine over the
    rows whose reference norm is at least ``row_floor`` of the RMS row norm)."""
    got = got.float().reshape(-1, got.shape[-1])
    want = want.float().reshape(-1, want.shape[-1])
    err = (got - want).abs().max().item()
    norms = want.double().norm(dim=-1)
    kept = norms >= row_floor * norms.square().mean().sqrt()
    cos = torch.nn.functional.cosine_similarity(got[kept], want[kept], dim=-1,
                                                eps=1e-30).min().item()
    ok = cos >= cos_min and err <= BF16_REL_ABS * want.abs().max().item()
    return ok, err, cos
