"""Decode attention: the Whisper decoder's incremental step, one query row a
(batch, head) against the decode layout's K/V (``csrc/decode_attention.cu``).

The JAX package has no kernel here (XLA compiles the step); the port's plain
path for it, :func:`_reference_decode_attention`, upcasts the whole K/V to
f32 and runs two f32 products. The kernel reads K and V in their storage
dtype (bf16, or float8 e4m3 for the opt-in decode-bandwidth modes) and
upcasts in registers, with the same roundings: q times the scale rounded to
the compute dtype, f32 scores and softmax, the probabilities rounded to the
compute dtype before the product with v, f32 accumulation, the output in the
compute dtype. A call is one launch: a row of Tk positions is one
thread-block cluster of :func:`cluster_size` blocks, one a ``CHUNK`` of
positions.

:func:`decode_attention` takes the plain version for a CPU tensor and
launches the kernel for a CUDA one: q (B, 1, H, 64) bf16, k (pre-scaled) and
v (B, H, Tk, 64), Tk <= ``MAX_TK``, contiguous, both bf16 or both float8
e4m3, 16-byte aligned, on q's device; it raises on anything else, and never
falls back. :func:`takes` is the decode step's choice of route, made by
dtype, head width and length: operands it sends here that the kernel cannot
read are a fault, not a reason for the plain path. ``pos``, a (1,) int64
device index, makes positions [0, pos] the valid ones (a self-attention
cache; the position never reaches the host, so the call can be captured in
a CUDA graph); without it all Tk are (the held cross K/V).

``decode_attention.launches`` counts the kernel's runs, and
``decode_attention.clusters`` the same runs by cluster size: the wrapper's
calls and, for a captured step, each replay's (``models/whisper/generate.py``
adds those).
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from wealy_tpu_torch import _build

HEAD_DIM = 64
CHUNK = 256  # kChunk: positions a block
MAX_TK = 8 * CHUNK  # kMaxSplit blocks a cluster, the portable cluster size
KV_KINDS = {torch.bfloat16: 0, torch.float8_e4m3fn: 1}  # storage dtype -> kv_kind


def cluster_size(tk: int) -> int:
    """Blocks of a row's cluster: one a ``CHUNK`` of its Tk positions."""
    return -(-tk // CHUNK)


def position_mask(pos: torch.Tensor, tk: int) -> torch.Tensor:
    """(Tk,) additive mask: 0 at positions [0, pos], -inf past it."""
    key_pos = torch.arange(tk, device=pos.device)
    return torch.where(key_pos <= pos, 0.0, float("-inf"))


def _reference_decode_attention(q, k, v, scale: float, mask: Optional[torch.Tensor] = None):
    """The plain decode-layout attention (``MultiHeadAttention``'s): q
    (B, Tq, H, Dh) in the compute dtype, unscaled; k (pre-scaled) and v
    (B, H, Tk, Dh) in any storage dtype, upcast here; ``mask`` additive,
    broadcast over (Tq, Tk). f32 scores of the rounded q, f32 softmax,
    weights rounded to q's dtype, f32 product; (B, Tq, H, Dh) in q's dtype."""
    qt = (q * scale).transpose(1, 2)
    logits = qt.float() @ k.float().transpose(-1, -2)
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return (w.float() @ v.float()).transpose(1, 2).to(q.dtype)


def takes(q, k) -> bool:
    """Whether a decode step on the card sends these operands to the kernel:
    bf16 q with bf16 or float8 e4m3 K/V of at most ``MAX_TK`` positions (every
    Whisper shape: 1500 audio frames, caches of at most 448), and the head
    width of every published Whisper size (64). float8 e5m2 storage, an f32
    compute dtype, other head widths (the ``dev`` stand-in's 32) and longer
    K/V take the plain path; a layout the kernel refuses is left to
    :func:`decode_attention` to raise on."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and k.dtype in KV_KINDS
            and q.shape[-1] == HEAD_DIM and k.shape[2] <= MAX_TK)


def _layout_ok(q, k, v, pos) -> bool:
    B, Tq, H, Dh = q.shape
    return (
        q.device.type == "cuda"
        and k.device == q.device
        and v.device == q.device
        and q.dtype == torch.bfloat16
        and k.dtype in KV_KINDS
        and v.dtype == k.dtype
        and Tq == 1
        and Dh == HEAD_DIM
        and k.dim() == 4
        and k.shape[:2] == (B, H)
        and k.shape[3] == Dh
        and v.shape == k.shape
        and 1 <= k.shape[2] <= MAX_TK
        and all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v))
        and (pos is None
             or (pos.device == q.device and pos.dtype == torch.long and pos.numel() == 1))
    )


def _launch(q, k, v, scale: float, pos: Optional[torch.Tensor]):
    if not _layout_ok(q, k, v, pos):
        raise ValueError(
            "decode_attention: the kernel takes bf16 CUDA q (B, 1, H, 64) and contiguous, "
            "16-byte aligned k, v (B, H, Tk, 64), both bf16 or both float8_e4m3fn, and pos a "
            f"(1,) int64 index on q's device or None; got q {tuple(q.shape)} {q.dtype} "
            f"{q.device}, k {tuple(k.shape)} {k.dtype} {k.device}, v {tuple(v.shape)} "
            f"{v.dtype}" + ("" if pos is None else f", pos {tuple(pos.shape)} {pos.dtype}")
        )
    B, _, H, Dh = q.shape
    tk = k.shape[2]
    out = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    _build.check(
        _build.library().wealy_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if pos is None else pos.data_ptr(),
            out.data_ptr(), B * H, tk, Dh, KV_KINDS[k.dtype], float(scale),
            _build.stream(q.device),
        ),
        "decode_attention",
    )
    decode_attention.launches += 1
    decode_attention.clusters[cluster_size(tk)] += 1
    return out


def decode_attention(q, k, v, scale: float, pos: Optional[torch.Tensor] = None):
    """softmax((q * scale) k^T) v for one query row a (batch, head): q
    (B, 1, H, 64), k (pre-scaled) and v (B, H, Tk, 64); ``pos`` a (1,)
    device index (positions past it excluded) or None. Returns
    (B, 1, H, 64) in q's dtype."""
    if q.device.type == "cpu":
        mask = None if pos is None else position_mask(pos, k.shape[2])
        return _reference_decode_attention(q, k, v, scale, mask)
    return _launch(q, k, v, scale, pos)


decode_attention.launches = 0
decode_attention.clusters = Counter()
