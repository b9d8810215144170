"""Model FLOPs of Whisper, from the configuration's sizes (the keys of the
published ``config.json``): two FLOPs a multiply-add, products only (the
norms, softmax and activations are left out).

- :func:`encoder_flops`: one 30 s chunk through the conv stem and the
  encoder blocks (QKV and output projections 8 T D^2, attention 4 T^2 D,
  MLP 4 T D Dff a block).
- :func:`decoder_flops`: one chunk's greedy decode of ``length`` positions
  (prompt included): the cross-attention K/V made once, then each position's
  projections, self-attention over the positions before it, cross-attention
  over the audio positions, MLP and logits.
"""

from __future__ import annotations

N_FRAMES = 3000  # mel frames in a 30 s chunk


def encoder_flops(cfg: dict) -> float:
    D, L = cfg["d_model"], cfg["encoder_layers"]
    T, Dff, M = cfg["max_source_positions"], cfg["encoder_ffn_dim"], cfg["num_mel_bins"]
    stem = 2.0 * N_FRAMES * D * M * 3 + 2.0 * T * D * D * 3
    block = 8.0 * T * D * D + 4.0 * T * T * D + 4.0 * T * D * Dff
    return stem + L * block


def decoder_flops(cfg: dict, length: int) -> float:
    D, L = cfg["d_model"], cfg["decoder_layers"]
    Ta, Dff, V = cfg["max_source_positions"], cfg["decoder_ffn_dim"], cfg["vocab_size"]
    cross_kv = L * 2 * 2.0 * Ta * D * D
    total = cross_kv
    for t in range(length):
        per_layer = (8.0 * D * D  # self q, k, v, out
                     + 4.0 * (t + 1) * D  # self-attention over t + 1 positions
                     + 4.0 * D * D  # cross q, out
                     + 4.0 * Ta * D  # cross-attention over the audio
                     + 4.0 * D * Dff)  # MLP
        total += L * per_layer + 2.0 * D * V  # logits
    return total
