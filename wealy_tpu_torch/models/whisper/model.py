"""Whisper encoder/decoder in PyTorch (counterpart of
``wealy_tpu.models.whisper.model``).

Parameter names follow openai-whisper (``encoder.blocks.N.attn.query``,
``mlp.0``/``mlp.2``, ``attn_ln``, ``cross_attn``, ``decoder.token_embedding``
...), so its checkpoints load with ``load_state_dict``. Numerics follow the
JAX model:

- Dense and conv weights are stored in the compute dtype (Flax casts its
  f32 params at every call, which rounds identically; training keeps f32
  master copies beside them, ``train/state.py``); LayerNorm params, the
  MLP biases (the fused kernel adds them in f32), the token and position
  embeddings and the encoder position table stay f32.
- LayerNorm takes f32 statistics and an f32 affine transform, rounded once
  to the stream's dtype (the JAX model's ``nn.LayerNorm(dtype=f32)`` and
  ``astype``). On the card it is kernel K6 (``ops/layer_norm.py``) for a bf16
  or f32 stream (:func:`_ln`), and each residual add runs in the same K6
  pass as the LayerNorm that reads its sum (:func:`_add_ln`): the block's
  ``x + attn`` with ``cross_attn_ln`` or ``mlp_ln``, its ``x + mlp`` with the
  next block's ``attn_ln`` or the stack's final LayerNorm. The sum is
  rounded as ``x + y`` rounds it, so the numbers are those of the add
  followed by the LayerNorm. The encoder's stream is row-major (B, T, D)
  from the stem on. Off K6 (the CPU, other dtypes) the add and
  ``F.layer_norm`` on the f32 upcast run apart.
- Attention logits and softmax are f32 with products of the rounded
  operands accumulated in f32.
- Mask-free, cache-free self-attention with Tq >= 256 (the encoder) goes to
  the fused attention kernel K2 (``flash_mha``); bf16 MLPs with T >= 256 go to
  the fused MLP kernel K3 (``fused_mlp``). Elsewhere the plain path runs, with
  MLP biases added in the compute dtype as in the JAX non-fused branch. An
  MLP of int8 projections (the encoder of ``quant.py``) runs them as they
  are, with the exact GELU between.
- Incremental decode computes logits from operands rounded to the compute
  dtype, multiplied in f32 (keep TF32 off); teacher-forced logits are f32.
  A decode loop passes the embedding in the compute dtype as
  ``logit_weight``, made once (:meth:`WhisperDecoder.logit_table`), instead
  of rounding it every step; on the card that product is one bf16 x bf16
  product with f32 accumulation and f32 output (:func:`step_logits`).
- The incremental step's attention (one token, the decode layout) goes on
  the card to the decode attention kernel (``ops/decode_attention.py``),
  which reads the K/V in their storage dtype with the plain path's
  roundings. The route is chosen by dtype, head width and length alone
  (``ops/decode_attention.py::takes``): a bf16 model's step over bf16 or
  float8 e4m3 K/V of every Whisper length always takes the kernel, which
  raises on a layout it cannot read; float8 e5m2 storage, f32-compute
  models, head widths other than 64, K/V longer than ``MAX_TK``, the
  prefill, teacher forcing and the CPU take the plain path.

Tensor parallelism (``parallel/tp.py``): built with a ``tp`` context, an
attention module holds ``n_head / n`` heads of the ``n`` ranks of the
``model`` axis (q/k/v column-parallel, its out-projection row-parallel) and
an MLP ``4D / n`` hidden columns; the row-parallel partial sums are reduced
over the axis (reduce-scattered along time under sequence parallelism) and
their bias is added once, after the reduction. The same kernels run on each
rank's contiguous shard: K2 at the rank's heads, K3 with the rank's
columns and a zero ``b2``.

Self-attention KV caches are (B, H, Tmax, Dh) for k (pre-scaled by
Dh**-0.25) and v, and are updated IN PLACE by ``decode`` in two ways: the
prefill (``cache_index=0``, T tokens) writes and reads positions [0, T)
under a causal mask; the incremental step (a (1,) device ``cache_index``,
one token: the static-shape step of ``generate.py``) writes its k/v by
``index_copy_`` and reads all Tmax positions under an additive -inf mask
past the index, as the JAX model does (``model.py:466-484`` there; the
decode attention kernel reads positions [0, index] alone). A cache (or a
precomputed cross K/V) may be stored in float8 (the opt-in decode-bandwidth
modes of the JAX model, ``model.py:98-130`` there): new k/v are cast into it
from the compute dtype, and the attention upcasts at the read (the kernel
takes float8 e4m3 in registers; e5m2 takes the plain path).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.ops.decode_attention import (
    _reference_decode_attention,
    decode_attention,
    position_mask,
    takes,
)
from wealy_tpu_torch.ops.flash_attention import flash_mha
from wealy_tpu_torch.ops.fused_mlp import fused_mlp
from wealy_tpu_torch.ops.layer_norm import (
    _aten_add_ln,
    _aten_ln,
    fused_add_layer_norm,
    fused_layer_norm,
)
from wealy_tpu_torch.ops.layer_norm import takes as k6_takes
from wealy_tpu_torch.utils.profiling import trace_span


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Fixed sinusoidal position embedding (sin | cos concatenation)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


FLOAT8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def is_float8(dtype) -> bool:
    """Whether ``dtype`` is a float8 storage dtype (the opt-in KV modes)."""
    return dtype in FLOAT8_DTYPES


def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics and affine, in x's dtype: one K6 pass
    where K6 takes x (``ops/layer_norm.py::takes``), else ``F.layer_norm`` on
    x's f32 upcast."""
    if k6_takes(x):
        return fused_layer_norm(x, ln.weight, ln.bias, ln.eps)
    return _aten_ln(x, ln.weight, ln.bias, ln.eps)


def _add_ln(ln: nn.LayerNorm, x: torch.Tensor, y: torch.Tensor):
    """``(x + y, _ln(ln, x + y))``: the residual add and the LayerNorm that
    reads its sum, one K6 pass where K6 takes x."""
    if k6_takes(x):
        return fused_add_layer_norm(x, y, ln.weight, ln.bias, ln.eps)
    return _aten_add_ln(x, y, ln.weight, ln.bias, ln.eps)


def _write_cache(cache: torch.Tensor, at, new: torch.Tensor) -> None:
    """``new`` (B, H, T, Dh) into ``cache`` along time at ``at``: a slice, or
    a (1,) device index (T = 1). A float8 cache takes the bytes of the cast
    from the compute dtype (the JAX model's astype)."""
    if is_float8(cache.dtype):
        cache, new = cache.view(torch.uint8), new.to(cache.dtype).view(torch.uint8)
    if torch.is_tensor(at):
        cache.index_copy_(2, at, new.to(cache.dtype))
    else:
        cache[:, :, at] = new


def _tp_heads(n_head: int, tp) -> int:
    n = 1 if tp is None else tp.size
    if n_head % n:
        raise ValueError(f"{n_head} heads do not split over {n} model ranks")
    return n_head // n


def step_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """f32 logits of states ``x`` (..., D) in the compute dtype against the
    logit table (V, D) (:meth:`WhisperDecoder.logit_table`): the product of
    the rounded operands with f32 accumulation and f32 output, one bf16
    product on the card and an upcast elsewhere (the same values). On the
    card the table is the left operand: the (V, rows) output's leading
    dimension is the row count, which cuBLAS aligns (a vocabulary of 51866
    columns does not), then transposed into place."""
    if x.is_cuda and table.dtype != torch.float32:
        flat = torch.mm(table, x.reshape(-1, x.shape[-1]).T, out_dtype=torch.float32)
        return flat.T.contiguous().view(*x.shape[:-1], table.shape[0])
    return x.float() @ table.float().T


class MultiHeadAttention(nn.Module):
    """Whisper MHA: q and k scaled by Dh**-0.25 each, ``key`` has no bias.
    With ``tp``, the rank's ``n_head / n`` heads (``n_head`` is then the
    rank's count)."""

    def __init__(self, n_state: int, n_head: int, dtype=torch.bfloat16, device=None, tp=None):
        super().__init__()
        self.tp = tp
        self.n_head = _tp_heads(n_head, tp)
        self.head_dim = n_state // n_head
        inner = self.n_head * self.head_dim
        kw = dict(dtype=dtype, device=device)
        self.query = nn.Linear(n_state, inner, **kw)
        self.key = nn.Linear(n_state, inner, bias=False, **kw)
        self.value = nn.Linear(n_state, inner, **kw)
        self.out = nn.Linear(inner, n_state, **kw)

    def cross_kv(self, xa: torch.Tensor):
        """Decode-layout (k pre-scaled, v), each (B, H, Tk, Dh), from memory xa."""
        if self.tp is not None:
            xa = self.tp.copy(xa)
        B, Tk, _ = xa.shape
        H, Dh = self.n_head, self.head_dim
        k = (self.key(xa).view(B, Tk, H, Dh) * Dh**-0.25).transpose(1, 2).contiguous()
        v = self.value(xa).view(B, Tk, H, Dh).transpose(1, 2).contiguous()
        return k, v

    def _project(self, o: torch.Tensor) -> torch.Tensor:
        """The out-projection; under TP row-parallel, its bias added once
        after the reduction."""
        if self.tp is None:
            return self.out(o)
        return self.tp.exit(F.linear(o, self.out.weight), self.out.bias)

    def forward(self, x, xa=None, mask=None, kv_cache=None, cache_index=None, xa_kv=None):
        if self.tp is not None:
            x = self.tp.enter(x)
            xa = None if xa is None else self.tp.copy(xa)
        B, Tq, _ = x.shape
        H, Dh = self.n_head, self.head_dim
        scale = Dh**-0.25
        q = self.query(x).view(B, Tq, H, Dh)
        if xa_kv is not None:
            k, v = xa_kv  # decode layout, precomputed
        else:
            src = x if xa is None else xa
            k = self.key(src).view(B, -1, H, Dh)
            v = self.value(src).view(B, -1, H, Dh)

        if mask is None and kv_cache is None and xa is None and xa_kv is None and Tq >= 256:
            out = flash_mha(q, k, v, Dh**-0.5)
            return self._project(out.reshape(B, Tq, H * Dh).to(x.dtype))

        if kv_cache is not None:
            ck, cv = kv_cache
            static = torch.is_tensor(cache_index)
            at = cache_index if static else slice(0, Tq)
            _write_cache(ck, at, (k * scale).transpose(1, 2))
            _write_cache(cv, at, v.transpose(1, 2))
            # the prefill's positions, or (a device index) the whole cache
            # under the caller's mask
            k, v = (ck, cv) if static else (ck[:, :, :Tq], cv[:, :, :Tq])

        if kv_cache is not None or xa_kv is not None:
            # decode layout: k (B, H, Tk, Dh) pre-scaled, v (B, H, Tk, Dh) in
            # their storage dtype. One token (a step against the held cross
            # K/V, or against the cache at a device position, whose mask is
            # the position's) goes to the decode attention kernel when its
            # dtypes and head width are the kernel's (the module docstring)
            pos = cache_index if kv_cache is not None else None
            step = Tq == 1 and (static if kv_cache is not None else mask is None)
            if step and takes(q, k):
                out = decode_attention(q, k, v, scale, pos)
            else:
                out = _reference_decode_attention(q, k, v, scale, mask)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), (k * scale).float())
            if mask is not None:
                logits = logits + mask
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())
        return self._project(out.reshape(B, Tq, H * Dh).to(x.dtype))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention (+ cross-attention) + MLP block (with ``tp``, the
    rank's heads and ``4 * n_state / n`` MLP columns)."""

    def __init__(
        self, n_state: int, n_head: int, cross_attention: bool = False,
        dtype=torch.bfloat16, device=None, tp=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.tp = tp
        self.attn = MultiHeadAttention(n_state, n_head, dtype, device, tp)
        self.attn_ln = nn.LayerNorm(n_state, eps=1e-5, device=device)
        self.cross_attn = (
            MultiHeadAttention(n_state, n_head, dtype, device, tp) if cross_attention else None
        )
        self.cross_attn_ln = (
            nn.LayerNorm(n_state, eps=1e-5, device=device) if cross_attention else None
        )
        n_mlp = 4 * n_state // (1 if tp is None else tp.size)
        self.mlp = nn.Sequential(
            nn.Linear(n_state, n_mlp, dtype=dtype, device=device),
            nn.GELU(),
            nn.Linear(n_mlp, n_state, dtype=dtype, device=device),
        )
        # MLP biases stay f32: the fused kernel adds them in f32
        self.mlp[0].bias = nn.Parameter(torch.zeros(n_mlp, device=device))
        self.mlp[2].bias = nn.Parameter(torch.zeros(n_state, device=device))
        self.mlp_ln = nn.LayerNorm(n_state, eps=1e-5, device=device)

    def forward(self, x, h, next_ln=None, xa=None, mask=None, kv_cache=None, cache_index=None,
                xa_kv=None):
        """(the new stream, ``next_ln`` of it or None without ``next_ln``)
        from the stream ``x`` and ``h = attn_ln(x)``, which the stack made
        with the previous residual add (:func:`run_blocks`). Each residual
        add runs with the LayerNorm that reads its sum (:func:`_add_ln`)."""
        a = self.attn(h, mask=mask, kv_cache=kv_cache, cache_index=cache_index)
        if self.cross_attn is not None:
            x, h = _add_ln(self.cross_attn_ln, x, a)
            a = self.cross_attn(h, xa=xa, xa_kv=xa_kv)
        x, h = _add_ln(self.mlp_ln, x, a)
        h = self._mlp(h)
        if next_ln is None:
            return x + h, None
        return _add_ln(next_ln, x, h)

    def _mlp(self, h):
        fc1, fc2 = self.mlp[0], self.mlp[2]
        if not isinstance(fc1, nn.Linear):
            # int8 projections (models/whisper/quant.py), each rounded to h's dtype
            return self.mlp(h)
        # under TP the rank's partial sum takes a zero b2; fc2's bias is
        # added once, after the reduction
        b2 = fc2.bias if self.tp is None else torch.zeros_like(fc2.bias)
        if self.tp is not None:
            h = self.tp.enter(h)
        if self.dtype == torch.bfloat16 and h.shape[1] >= 256:
            h = fused_mlp(h, fc1.weight, fc1.bias, fc2.weight, b2)
        else:
            h = F.linear(h, fc1.weight) + fc1.bias.to(h.dtype)
            h = F.gelu(h, approximate="none")
            h = F.linear(h, fc2.weight) + b2.to(h.dtype)
        if self.tp is not None:
            h = self.tp.exit(h, fc2.bias)
        return h


def _stack_lns(blocks, final_ln):
    """Each block's following LayerNorm: the next block's ``attn_ln``, and
    ``final_ln`` after the last."""
    return [b.attn_ln for b in blocks[1:]] + [final_ln]


def run_blocks(blocks, x, final_ln=None):
    """The stack ``blocks`` (no cross-attention) on the stream ``x``: (the
    stream after the last block, ``final_ln`` of it or None). The encoder
    and a pipeline stage (``parallel/pp.py``) run their blocks so."""
    h = _ln(blocks[0].attn_ln, x)
    for block, next_ln in zip(blocks, _stack_lns(blocks, final_ln)):
        x, h = block(x, h, next_ln)
    return x, h


class WhisperEncoder(nn.Module):
    """Mel (B, n_mels, 3000) -> audio states (B, 1500, D). With a ``tp``
    context of sequence parallelism, the residual stream between blocks
    holds this rank's ``T / n`` time steps."""

    def __init__(self, config: WhisperConfig, dtype=torch.bfloat16, device=None, tp=None):
        super().__init__()
        D = config.n_audio_state
        self.config = config
        self.dtype = dtype
        self.tp = tp
        kw = dict(dtype=dtype, device=device)
        self.conv1 = nn.Conv1d(config.n_mels, D, 3, padding=1, **kw)
        self.conv2 = nn.Conv1d(D, D, 3, stride=2, padding=1, **kw)
        # a loaded table (checkpoint or exact host numpy), never recomputed on
        # device; a parameter, as in the JAX model, so training updates it
        self.positional_embedding = nn.Parameter(
            torch.from_numpy(sinusoids(config.n_audio_ctx, D)).to(device)
        )
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(D, config.n_audio_head, dtype=dtype, device=device, tp=tp)
            for _ in range(config.n_audio_layer)
        )
        self.ln_post = nn.LayerNorm(D, eps=1e-5, device=device)

    def stem(self, mel: torch.Tensor) -> torch.Tensor:
        """The conv stem and the position table: mel -> a row-major (B, T,
        D) stream."""
        x = F.gelu(self.conv1(mel.to(self.dtype)), approximate="none")
        x = F.gelu(self.conv2(x), approximate="none").transpose(1, 2)  # (B, T, D) view
        # the row-major table first: the sum takes its layout, not the
        # transposed view's
        return self.positional_embedding[: x.shape[1]].to(self.dtype) + x

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.stem(mel)
        sp = self.tp is not None and self.tp.sequence_parallel
        if sp:
            x = self.tp.split_time(x)
        # n: 1 when every LayerNorm pass of the forward ran on K6
        with trace_span("whisper.encoder_ln") as span:
            launched = fused_layer_norm.launches
            _, h = run_blocks(self.blocks, x, self.ln_post)
            span.n = int(fused_layer_norm.launches - launched == 2 * len(self.blocks) + 1)
        # LayerNorm is row-wise: the gathered rows of the normalised stream
        return self.tp.gather_time(h) if sp else h


class WhisperDecoder(nn.Module):
    """Token ids (B, T) + encoder states -> hidden states (B, T, D) and logits.

    With ``kv_caches`` set it updates the self-attention caches in place:
    ``cache_index=0`` is the prefill (the T prompt tokens at positions
    0..T-1), a (1,) device ``cache_index`` the incremental step (one token
    at that position, against the whole cache); no other index is taken.
    """

    def __init__(self, config: WhisperConfig, dtype=torch.bfloat16, device=None, tp=None):
        super().__init__()
        D = config.n_text_state
        self.config = config
        self.dtype = dtype
        self.token_embedding = nn.Embedding(config.n_vocab, D, device=device)
        self.positional_embedding = nn.Parameter(
            torch.zeros(config.n_text_ctx, D, device=device)
        )
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(
                D, config.n_text_head, cross_attention=True, dtype=dtype, device=device, tp=tp
            )
            for _ in range(config.n_text_layer)
        )
        self.ln = nn.LayerNorm(D, eps=1e-5, device=device)

    def logit_table(self) -> torch.Tensor:
        """The token embedding in the compute dtype: the table of every
        incremental step's logits (:func:`step_logits`)."""
        return self.token_embedding.weight.to(self.dtype)

    def forward(
        self,
        tokens: torch.Tensor,
        audio_states: Optional[torch.Tensor],
        kv_caches=None,
        cache_index=None,
        return_all_hiddens: bool = False,
        xa_kv=None,
        logit_weight: Optional[torch.Tensor] = None,
    ):
        T = tokens.shape[1]
        embed = self.token_embedding.weight
        dev = tokens.device
        if torch.is_tensor(cache_index):
            # the static-shape step: one token at a (1,) device position,
            # its row of the table by index, every cache position past it
            # masked (the JAX model's key_pos <= q_pos over Tmax)
            if T != 1 or kv_caches is None:
                raise ValueError("a device cache_index takes one token and the KV caches")
            pos = self.positional_embedding.index_select(0, cache_index)
            mask = position_mask(cache_index, kv_caches[0][0].shape[2])
        else:
            # teacher forcing, or the prefill at position 0: causal over T
            if cache_index not in (None, 0):
                raise ValueError("an int cache_index is the prefill's 0; a step takes a (1,) "
                                 "device index")
            pos = self.positional_embedding[:T]
            mask = torch.full((T, T), float("-inf"), device=dev).triu(1)
        x = embed[tokens].to(self.dtype) + pos.to(self.dtype)

        all_hiddens = [x]
        # with the caches only the final LayerNorm's rounding to the compute
        # dtype is read, so it runs with the last residual add; teacher
        # forcing reads it in f32 (the logits), after the stack
        next_lns = _stack_lns(self.blocks, self.ln if kv_caches is not None else None)
        h = _ln(self.blocks[0].attn_ln, x)
        for i, (block, next_ln) in enumerate(zip(self.blocks, next_lns)):
            x, h = block(
                x,
                h,
                next_ln,
                xa=audio_states,
                mask=mask,
                kv_cache=None if kv_caches is None else kv_caches[i],
                cache_index=cache_index,
                xa_kv=None if xa_kv is None else xa_kv[i],
            )
            if return_all_hiddens:
                all_hiddens.append(x)

        if kv_caches is not None:
            hidden = h
            if logit_weight is None:
                logit_weight = self.logit_table()
            logits = step_logits(hidden, logit_weight)
        else:
            x = _ln(self.ln, x.float())
            logits = x @ embed.T
            hidden = x.to(self.dtype)
        extras = [torch.stack(all_hiddens)] if return_all_hiddens else []
        if kv_caches is None:
            return (hidden, logits, *extras)
        return (hidden, logits, kv_caches, *extras)


class Whisper(nn.Module):
    """Full encoder-decoder with ``encode`` / ``decode`` / ``precompute_cross_kv``
    (``tp``: the tensor-parallel context of both stacks; sequence
    parallelism applies to the encoder only)."""

    def __init__(self, config: WhisperConfig, dtype=torch.bfloat16, device=None, tp=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.encoder = WhisperEncoder(config, dtype, device, tp)
        self.decoder = WhisperDecoder(config, dtype, device, None if tp is None else tp.plain())

    @property
    def device(self) -> torch.device:
        return self.decoder.token_embedding.weight.device

    def forward(self, mel, tokens):
        return self.decoder(tokens, self.encoder(mel))

    def encode(self, mel):
        return self.encoder(mel)

    def decode(
        self, tokens, audio_states, kv_caches=None, cache_index=None,
        return_all_hiddens: bool = False, xa_kv=None, logit_weight=None,
    ):
        return self.decoder(
            tokens, audio_states, kv_caches=kv_caches, cache_index=cache_index,
            return_all_hiddens=return_all_hiddens, xa_kv=xa_kv, logit_weight=logit_weight,
        )

    def precompute_cross_kv(self, audio_states):
        """Per-layer cross-attention (k, v) in decode layout, computed once
        and passed to every ``decode`` step as ``xa_kv``."""
        return [block.cross_attn.cross_kv(audio_states) for block in self.decoder.blocks]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Whisper":
        """Seeded random init (:meth:`seeded_weights`) copied into the
        parameters."""
        params = dict(self.named_parameters())
        for name, value in self.seeded_weights(generator):
            params[name].copy_(value)
        return self

    def seeded_weights(self, generator: torch.Generator):
        """(name, f32 value) of every parameter in ``named_parameters``
        order, the encoder's first: Dense/conv weights N(0, 1/fan_in),
        biases 0, LayerNorm 1/0, token embedding N(0, 0.02), decoder
        positions N(0, 0.01), the encoder position table the exact
        sinusoids. The numbers are drawn on ``generator``'s device, so a CPU
        generator gives every device the same weights; only the parameters'
        shapes are read (a ``meta`` model gives the f32 draw without
        holding the model)."""
        ln_weights = {
            id(m.weight) for m in self.modules() if isinstance(m, nn.LayerNorm)
        }
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                yield name, torch.zeros(p.shape)
            elif id(p) in ln_weights:
                yield name, torch.ones(p.shape)
            elif name == "encoder.positional_embedding":
                yield name, torch.from_numpy(sinusoids(*p.shape))
            else:
                if name == "decoder.token_embedding.weight":
                    std = 0.02
                elif name == "decoder.positional_embedding":
                    std = 0.01
                else:
                    std = (p[0].numel()) ** -0.5  # fan_in of (out, in[, k])
                noise = torch.randn(
                    p.shape, generator=generator, device=generator.device, dtype=torch.float32
                )
                yield name, noise * std
