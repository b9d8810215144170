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
- LayerNorm runs in f32 and is cast back; attention logits and softmax are
  f32 with products of the rounded operands accumulated in f32.
- Mask-free, cache-free self-attention with Tq >= 256 (the encoder) goes to
  the fused attention kernel K2 (``flash_mha``); bf16 MLPs with T >= 256 go to
  the fused MLP kernel K3 (``fused_mlp``). Elsewhere the plain path runs, with
  MLP biases added in the compute dtype as in the JAX non-fused branch.
- Incremental decode computes logits from operands rounded to the compute
  dtype, multiplied in f32 (keep TF32 off); teacher-forced logits are f32.
  A decode loop passes the rounded embedding as ``logit_weight``, made once
  (:meth:`WhisperDecoder.rounded_embedding`), instead of rounding it every
  step.

Tensor parallelism (``parallel/tp.py``): built with a ``tp`` context, an
attention module holds ``n_head / n`` heads of the ``n`` ranks of the
``model`` axis (q/k/v column-parallel, its out-projection row-parallel) and
an MLP ``4D / n`` hidden columns; the row-parallel partial sums are reduced
over the axis (reduce-scattered along time under sequence parallelism) and
their bias is added once, after the reduction. The same kernels run on each
rank's contiguous shard: K2 at the rank's heads, K3 with the rank's
columns and a zero ``b2``.

Self-attention KV caches are (B, H, Tmax, Dh) for k (pre-scaled by
Dh**-0.25) and v, and are updated IN PLACE by ``decode``; attention reads
only the filled prefix [0, cache_index + T). A cache (or a precomputed
cross K/V) may be stored in float8 (the opt-in decode-bandwidth modes of
the JAX model, ``model.py:98-130`` there): new k/v are cast into it from
the compute dtype, and the attention products upcast at the read.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.ops.flash_attention import flash_mha
from wealy_tpu_torch.ops.fused_mlp import fused_mlp


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
    """LayerNorm in f32, cast back to the input dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(x.dtype)


def _tp_heads(n_head: int, tp) -> int:
    n = 1 if tp is None else tp.size
    if n_head % n:
        raise ValueError(f"{n_head} heads do not split over {n} model ranks")
    return n_head // n


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
            end = cache_index + Tq
            k_new, v_new = (k * scale).transpose(1, 2), v.transpose(1, 2)
            if is_float8(ck.dtype):
                # the cache lives at the storage dtype: the new k/v are cast
                # from the compute dtype (as the JAX model's astype) and
                # written as bytes; the products below upcast at the read
                ck.view(torch.uint8)[:, :, cache_index:end] = k_new.to(ck.dtype).view(torch.uint8)
                cv.view(torch.uint8)[:, :, cache_index:end] = v_new.to(cv.dtype).view(torch.uint8)
            else:
                ck[:, :, cache_index:end] = k_new
                cv[:, :, cache_index:end] = v_new
            k, v = ck[:, :, :end], cv[:, :, :end]

        if kv_cache is not None or xa_kv is not None:
            # decode layout: k (B, H, Tk, Dh) pre-scaled, v (B, H, Tk, Dh),
            # float8 storage (cross K/V or the self cache) upcast here
            qt = (q * scale).transpose(1, 2)
            logits = qt.float() @ k.float().transpose(-1, -2)
            if mask is not None:
                logits = logits + mask
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            out = (w.float() @ v.float()).transpose(1, 2)
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

    def forward(self, x, xa=None, mask=None, kv_cache=None, cache_index=None, xa_kv=None):
        x = x + self.attn(
            _ln(self.attn_ln, x), mask=mask, kv_cache=kv_cache, cache_index=cache_index
        )
        if self.cross_attn is not None:
            x = x + self.cross_attn(_ln(self.cross_attn_ln, x), xa=xa, xa_kv=xa_kv)
        h = _ln(self.mlp_ln, x)
        fc1, fc2 = self.mlp[0], self.mlp[2]
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
        return x + h


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
        """The conv stem and the position table: mel -> (B, T, D)."""
        x = F.gelu(self.conv1(mel.to(self.dtype)), approximate="none")
        x = F.gelu(self.conv2(x), approximate="none").transpose(1, 2)  # (B, T, D)
        return x + self.positional_embedding[: x.shape[1]].to(self.dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.stem(mel)
        sp = self.tp is not None and self.tp.sequence_parallel
        if sp:
            x = self.tp.split_time(x)
        for block in self.blocks:
            x = block(x)
        if sp:
            x = self.tp.gather_time(x)
        return _ln(self.ln_post, x)


class WhisperDecoder(nn.Module):
    """Token ids (B, T) + encoder states -> hidden states (B, T, D) and logits.

    With ``kv_caches``/``cache_index`` set, runs one incremental step
    (T new tokens at absolute positions cache_index..cache_index+T-1)
    against the self-attention caches, which it updates in place.
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

    def rounded_embedding(self) -> torch.Tensor:
        """The token embedding rounded to the compute dtype, in f32: the
        right operand of every incremental step's logits."""
        return self.token_embedding.weight.to(self.dtype).float()

    def forward(
        self,
        tokens: torch.Tensor,
        audio_states: Optional[torch.Tensor],
        kv_caches=None,
        cache_index: Optional[int] = None,
        return_all_hiddens: bool = False,
        xa_kv=None,
        logit_weight: Optional[torch.Tensor] = None,
    ):
        T = tokens.shape[1]
        embed = self.token_embedding.weight
        offset = 0 if cache_index is None else int(cache_index)
        x = embed[tokens].to(self.dtype) + self.positional_embedding[offset : offset + T].to(
            self.dtype
        )
        dev = tokens.device
        if kv_caches is None:
            mask = torch.full((T, T), float("-inf"), device=dev).triu(1)
        elif T > 1:
            # query t sits at offset + t and sees cache positions <= that
            key_pos = torch.arange(offset + T, device=dev)[None, :]
            q_pos = offset + torch.arange(T, device=dev)[:, None]
            mask = torch.where(key_pos <= q_pos, 0.0, float("-inf"))
        else:
            mask = None  # one new token sees the whole filled prefix

        all_hiddens = [x]
        for i, block in enumerate(self.blocks):
            x = block(
                x,
                xa=audio_states,
                mask=mask,
                kv_cache=None if kv_caches is None else kv_caches[i],
                cache_index=cache_index,
                xa_kv=None if xa_kv is None else xa_kv[i],
            )
            if return_all_hiddens:
                all_hiddens.append(x)

        x = F.layer_norm(x.float(), self.ln.normalized_shape, self.ln.weight, self.ln.bias,
                         self.ln.eps)
        if kv_caches is not None:
            if logit_weight is None:
                logit_weight = self.rounded_embedding()
            logits = x.to(self.dtype).float() @ logit_weight.T
        else:
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
