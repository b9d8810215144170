"""Multimodal fusion models, Whisper (lyric) branch x CLEWS (acoustic)
branch: the counterpart of ``wealy_tpu.models.fusion``.

  wealy-clews                          -> WealyClewsModel
  whisper-clews / multimodal-two-stream -> TwoStreamModel
  multimodal-cross-attention           -> WealyQueryFusion(CrossAttentionFusion)
  multimodal-concatenation             -> WealyQueryFusion(ConcatFusion)
  multimodal-cross-attention-residual  -> WealyQueryFusion(CrossAttentionFusion(residual))

Every head gives one (B, zdim) embedding, except the two-stream model,
which also gives both tower embeddings. Masks are True = valid. Torch
needs the input widths up front (``whisper_features``, ``clews_features``,
``wealy_features``) where flax infers them; parameter names follow the flax
modules so that ``models/convert.py`` carries JAX weights across.

The cross-attention is flax ``MultiHeadDotProductAttention`` in f32: query
/ key / value / out projections with biases, q scaled by 1/sqrt(head_dim),
masked logits set to the f32 minimum (not -inf), softmax in f32. So a row
whose keys are all masked (a version without CLEWS files) attends
uniformly to every key and stays finite, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wealy_tpu_torch.models.heads import ProjectionHead
from wealy_tpu_torch.models.layers import mean_pool


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (no dropout): ``query``,
    ``key``, ``value`` Linear(in, heads * head_dim) and ``out``
    Linear(heads * head_dim, out). mask: (B, 1 | heads, Tq, Tk) True =
    attend."""

    def __init__(self, num_heads: int, q_features: int, kv_features: int,
                 qkv_features: int = None, out_features: int = None):
        super().__init__()
        qkv_features = qkv_features or q_features
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = qkv_features // num_heads
        self.query = nn.Linear(q_features, qkv_features)
        self.key = nn.Linear(kv_features, qkv_features)
        self.value = nn.Linear(kv_features, qkv_features)
        self.out = nn.Linear(qkv_features, out_features or q_features)

    def forward(self, inputs_q, inputs_k, inputs_v, mask=None):
        B, Tq, _ = inputs_q.shape
        H, D = self.num_heads, self.head_dim
        q = self.query(inputs_q).reshape(B, Tq, H, D) / D**0.5
        k = self.key(inputs_k).reshape(B, -1, H, D)
        v = self.value(inputs_v).reshape(B, -1, H, D)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        x = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(x.reshape(B, Tq, H * D))


class CrossAttentionFusion(nn.Module):
    """The whisper sequence (queries) attends into the CLEWS sequence
    (keys/values); attended + query streams are pooled and projected to
    zdim. ``residual=True`` adds the concatenated pooled single-modal
    streams to the projection's input (the *-residual model name)."""

    def __init__(self, whisper_features: int, clews_features: int, zdim: int = 512,
                 width: int = 512, n_heads: int = 8, residual: bool = False):
        super().__init__()
        self.residual = residual
        self.q_in = nn.Linear(whisper_features, width)
        self.kv_in = nn.Linear(clews_features, width)
        self.cross_attn = MultiHeadDotProductAttention(n_heads, width, width)
        self.ln = nn.LayerNorm(width, eps=1e-5)
        pooled = width + (whisper_features + clews_features if residual else 0)
        self.proj = nn.Linear(pooled, zdim)

    def forward(self, whisper_seq, whisper_mask, clews_seq, clews_mask):
        q = self.q_in(whisper_seq)
        kv = self.kv_in(clews_seq)
        attn_mask = None if clews_mask is None else clews_mask[:, None, None, :].bool()
        fused = self.cross_attn(q, kv, kv, mask=attn_mask)
        fused = self.ln((fused + q).float()).to(q.dtype)
        z = mean_pool(fused, whisper_mask)
        if self.residual:
            z = torch.cat([z, mean_pool(whisper_seq, whisper_mask),
                           mean_pool(clews_seq, clews_mask)], dim=-1)
        return self.proj(z)


class ConcatFusion(nn.Module):
    """Pool each modality, concatenate, MLP -> zdim
    (multimodal-concatenation)."""

    def __init__(self, whisper_features: int, clews_features: int, zdim: int = 512,
                 hidden: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(whisper_features + clews_features, hidden)
        self.proj = nn.Linear(hidden, zdim)

    def forward(self, whisper_seq, whisper_mask, clews_seq, clews_mask):
        z = torch.cat([mean_pool(whisper_seq, whisper_mask), mean_pool(clews_seq, clews_mask)],
                      dim=-1)
        return self.proj(F.relu(self.fc1(z)))


class TwoStreamModel(nn.Module):
    """Independent projection towers per modality (whisper-clews /
    multimodal-two-stream). Returns (z_fused, z_whisper, z_clews); the
    fused embedding is the L2-normalized mean of the tower outputs."""

    def __init__(self, whisper_features: int, clews_features: int, zdim: int = 512):
        super().__init__()
        self.whisper_head = ProjectionHead(whisper_features, zdim=zdim)
        self.clews_head = ProjectionHead(clews_features, zdim=zdim)

    def forward(self, whisper_seq, whisper_mask, clews_seq, clews_mask):
        zw = self.whisper_head(whisper_seq, whisper_mask)
        zc = self.clews_head(clews_seq, clews_mask)
        z = 0.5 * (zw + zc)
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp(min=1e-12)
        return z, zw, zc


class WealyQueryFusion(nn.Module):
    """Adapter for the multimodal-cross-attention / -concatenation /
    -cross-attention-residual names, which train on the WEALY item format
    (one (512,) WEALY chunk embedding per version + the CLEWS context): the
    WEALY vector enters the sequence-fusion module ``inner`` as a length-1
    query sequence."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, wealy_vec, clews_seq, clews_mask=None):
        q = wealy_vec[:, None, :]  # (B, 1, C)
        qm = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
        return self.inner(q, qm, clews_seq, clews_mask)


class WealyClewsModel(nn.Module):
    """wealy-clews: the precomputed WEALY chunk embedding (B, 512) fused with
    the CLEWS sequence (B, 116, 2048) through a gated sum."""

    def __init__(self, wealy_features: int, clews_features: int, zdim: int = 512):
        super().__init__()
        self.clews_proj = nn.Linear(clews_features, zdim)
        self.wealy_proj = nn.Linear(wealy_features, zdim)
        self.gate = nn.Linear(2 * zdim, zdim)
        self.proj = nn.Linear(zdim, zdim)

    def forward(self, wealy_vec, clews_seq, clews_mask=None):
        zc = self.clews_proj(mean_pool(clews_seq, clews_mask))
        zw = self.wealy_proj(wealy_vec)
        gate = torch.sigmoid(self.gate(torch.cat([zw, zc], dim=-1)))
        return self.proj(gate * zw + (1.0 - gate) * zc)
