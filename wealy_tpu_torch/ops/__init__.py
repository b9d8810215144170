"""Kernels of the encoder: fused attention (K2, backward K5a/K5b) and fused MLP (K3)."""

from __future__ import annotations

import torch

# How close K2 and K3 must come to their plain versions: bf16 outputs whose
# sums run in another order, so a per-row cosine and a max-abs bound relative
# to the output's scale (one bf16 ulp is 2**-8 relative)
BF16_COS_MIN = 0.9999
BF16_REL_ABS = 2e-2
# K5a/K5b (the attention backward) against autograd of the plain attention:
# both round p and ds (the plain version dp too) to bf16 before products,
# at other places, and ds = p * (dp - delta) cancels, so rows agree less
BF16_GRAD_COS_MIN = 0.999


def bf16_agreement(got: torch.Tensor, want: torch.Tensor,
                   cos_min: float = BF16_COS_MIN) -> tuple[bool, float, float]:
    """(within the bound, max |got - want|, smallest per-row cosine)."""
    got = got.float().reshape(-1, got.shape[-1])
    want = want.float().reshape(-1, want.shape[-1])
    err = (got - want).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1, eps=1e-30).min().item()
    ok = cos >= cos_min and err <= BF16_REL_ABS * want.abs().max().item()
    return ok, err, cos
