"""Whisper in plain float32 PyTorch, from the openai-whisper description
(Radford et al. 2022, arXiv:2212.04356, and its published code), over an
openai-named state dict:

- encoder: two convolutions of width 3 (the second of stride 2) each
  followed by exact GELU, the sinusoidal position table, pre-LayerNorm
  blocks of self-attention and an MLP (exact GELU), a final LayerNorm;
- attention: q and k each scaled by Dh**-0.25, ``key`` without bias;
- decoder, teacher-forced: token and learned position embeddings, blocks of
  causal self-attention, cross-attention over the audio states and an MLP,
  a final LayerNorm; logits are the final states times the token embedding.

No kernels, caches or batching across chunks; every product in float32 with
TF32 off (:func:`exact`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact():
    """TF32 off for matrix products and convolutions, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _ln(sd, prefix, x):
    return F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], 1e-5)


def _lin(sd, prefix, x, bias=True):
    return F.linear(x, sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] if bias else None)


def _attention(sd, prefix, x, src, n_head, causal=False):
    B, Tq, D = x.shape
    Dh = D // n_head
    q = _lin(sd, f"{prefix}.query", x).view(B, Tq, n_head, Dh).transpose(1, 2)
    k = _lin(sd, f"{prefix}.key", src, bias=False).view(B, -1, n_head, Dh).transpose(1, 2)
    v = _lin(sd, f"{prefix}.value", src).view(B, -1, n_head, Dh).transpose(1, 2)
    s = (q * Dh**-0.25) @ (k * Dh**-0.25).transpose(-1, -2)
    if causal:
        Tk = k.shape[2]
        s = s.masked_fill(torch.ones(Tq, Tk, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
    o = torch.softmax(s, dim=-1) @ v
    return _lin(sd, f"{prefix}.out", o.transpose(1, 2).reshape(B, Tq, D))


def _mlp(sd, prefix, x):
    return _lin(sd, f"{prefix}.mlp.2", F.gelu(_lin(sd, f"{prefix}.mlp.0", x)))


def encode(sd: dict, cfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, 3000) -> audio states (B, 1500, D), float32."""
    x = F.gelu(F.conv1d(mel.float(), sd["encoder.conv1.weight"], sd["encoder.conv1.bias"],
                        padding=1))
    x = F.gelu(F.conv1d(x, sd["encoder.conv2.weight"], sd["encoder.conv2.bias"], stride=2,
                        padding=1)).transpose(1, 2)
    x = x + sd["encoder.positional_embedding"][: x.shape[1]]
    H = cfg["encoder_attention_heads"]
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.blocks.{i}"
        h = _ln(sd, f"{p}.attn_ln", x)
        x = x + _attention(sd, f"{p}.attn", h, h, H)
        x = x + _mlp(sd, p, _ln(sd, f"{p}.mlp_ln", x))
    return _ln(sd, "encoder.ln_post", x)


def decode(sd: dict, cfg: dict, tokens: torch.Tensor, audio: torch.Tensor):
    """Teacher-forced decoder: tokens (B, T), audio states (B, 1500, D) ->
    (final states (B, T, D), logits (B, T, V)), float32."""
    T = tokens.shape[1]
    emb = sd["decoder.token_embedding.weight"]
    x = emb[tokens] + sd["decoder.positional_embedding"][:T]
    H = cfg["decoder_attention_heads"]
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.blocks.{i}"
        h = _ln(sd, f"{p}.attn_ln", x)
        x = x + _attention(sd, f"{p}.attn", h, h, H, causal=True)
        x = x + _attention(sd, f"{p}.cross_attn", _ln(sd, f"{p}.cross_attn_ln", x), audio, H)
        x = x + _mlp(sd, p, _ln(sd, f"{p}.mlp_ln", x))
    x = _ln(sd, "decoder.ln", x)
    return x, x @ emb.T
