"""K3, the fused MLP (``ops.fused_mlp``): gelu(x W1^T + b1) W2^T + b2 over N
rows of width D, hidden width Dff; x, W1, W2 and the output bf16, the biases
f32. Two products of 2 * N * D * Dff operations; the hidden activations are
the kernel's own and are not counted."""

from __future__ import annotations

BF16, F32 = 2, 4


def ops(N: int, D: int, Dff: int) -> float:
    return 4.0 * N * D * Dff


def bytes_moved(N: int, D: int, Dff: int) -> float:
    return 2.0 * N * D * BF16 + 2.0 * D * Dff * BF16 + (Dff + D) * F32
