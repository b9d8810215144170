"""K2, the fused attention forward (``ops.flash_attention``): softmax(q k^T
* scale) v over (B, T, H, Dh) bf16 q, k and v, no mask, output (B, T, H, Dh)
bf16. Two products of 2 * T * T * Dh operations a head; q, k and v read
once and the output written once."""

from __future__ import annotations

BF16 = 2


def ops(B: int, T: int, H: int, Dh: int) -> float:
    return 4.0 * B * H * T * T * Dh


def bytes_moved(B: int, T: int, H: int, Dh: int) -> float:
    return 4.0 * B * T * H * Dh * BF16
