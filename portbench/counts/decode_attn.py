"""The decode attention kernel (``ops.decode_attention``): one query row a
(batch, head) against K and V of (B, H, Tk, Dh) in their storage dtype, q
and the output bf16. A call is two products of 2 * Tk * Dh operations a
row, in f32 on the CUDA cores; K and V are read once, q read once and the
output written once (the kernel's f32 scores and partial sums stay out of
the count: they are its own, not the work's). A greedy step at position t
makes, in each decoder layer, one self-attention call over the t + 1
cached positions [0, t] (not the whole ``max_len`` cache) and one
cross-attention call over the audio frames."""

from __future__ import annotations

BF16 = 2


def ops(B: int, H: int, Tk: int, Dh: int) -> float:
    return 4.0 * B * H * Tk * Dh


def bytes_moved(B: int, H: int, Tk: int, Dh: int, kv_bytes: int = BF16) -> float:
    return 2.0 * B * H * Tk * Dh * kv_bytes + 2.0 * B * H * Dh * BF16


def step_calls(cfg: dict, B: int, t: int, kv_bytes: int = BF16) -> list:
    """[(bytes, operations)] of the calls of one greedy step at position
    ``t`` of a batch of B, the configuration's decoder sizes."""
    H, L = cfg["decoder_attention_heads"], cfg["decoder_layers"]
    Dh, Ta = cfg["d_model"] // H, cfg["max_source_positions"]
    one = [(bytes_moved(B, H, t + 1, Dh, kv_bytes), ops(B, H, t + 1, Dh)),
           (bytes_moved(B, H, Ta, Dh, kv_bytes), ops(B, H, Ta, Dh))]
    return one * L
