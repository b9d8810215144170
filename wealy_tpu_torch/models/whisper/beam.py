"""Batched beam-search decoding with a flattened beam axis (counterpart of
``wealy_tpu.models.whisper.beam``): openai-whisper's ``BeamSearchDecoder``
and ``MaximumLikelihoodRanker`` on the rungs where ``beam_size`` is set.

- Beams ride the batch axis: every step decodes (B*K) rows at once.
- Prefill runs at B (the prompt is beam-independent); the caches are then
  repeated K times in beam-major order (row b*K + k is beam k of item b).
- Each step is the decoder step of ``generate.py``'s greedy loop (the
  position a device index, self-attention over the whole cache under a
  mask), so a beam of one is greedy bit for bit.
- Each step: ``log_softmax`` over the step logits; a finished beam is
  locked to an eot-only continuation at zero cost (its score freezes);
  candidates score ``sum_logprob[b, k] + logp[b, k, v]`` and the top K of
  the (K*V) flat candidates of each item are kept. Ties resolve as
  ``lax.top_k`` resolves them, the lower flat index first: the top K is a
  ``torch.topk`` over one int64 key per candidate that orders by value and
  then by index (:func:`top_k_first_index`), because ``torch.topk`` promises
  no order among equal values.
- The self-attention caches are reordered after each step by a gather of
  their filled prefix into a new tensor, copied back (float8 caches move as
  bytes). Tokens and hidden states are not reordered: each step records
  every slot's ancestor and token, hidden states are written in pre-reorder
  slot order, and one backtrack after the loop rebuilds every beam's path.
- Ranking: cumulative log-prob over generated length
  (``length_penalty=None``) or over ``((5 + n) / 6) ** length_penalty``;
  the final order is a stable sort, as ``jnp.argsort``.

Deviation from openai-whisper, as in the JAX package: finished beams stay in
the active set as frozen eot-extensions that live candidates must
out-score, instead of a side list collected until ``patience * beam_size``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.generate import (
    decode_cross_kv,
    decoded_lengths,
    init_kv_caches,
    nospeech_probability,
    suppress_mask,
)
from wealy_tpu_torch.models.whisper.model import Whisper, is_float8

_INDEX_BITS = 24  # flat candidate indices below 2**24: K*V for K <= 323 at V 51866


def rank_beams(sum_logprob, n_gen, length_penalty: Optional[float] = None):
    """openai-whisper's MaximumLikelihoodRanker: cumulative log-prob over a
    length penalty; ``n_gen`` counts generated tokens including the closing
    eot."""
    n = torch.clamp(n_gen.float(), min=1.0)
    penalty = n if length_penalty is None else ((5.0 + n) / 6.0) ** length_penalty
    return sum_logprob / penalty


def top_k_first_index(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row of the f32
    ``x``, largest first, equal values in ascending index order (the order
    of ``lax.top_k``). The f32 bits map to an int32 key in the IEEE total
    order that ``lax.top_k`` compares by (-0.0 below +0.0), widened with
    the complement of the index, so the int64 keys are distinct."""
    if x.shape[-1] >= 1 << _INDEX_BITS:
        raise ValueError(f"top_k_first_index: rows of {x.shape[-1]} entries")
    bits = x.float().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    index = torch.arange(x.shape[-1], device=x.device)
    key = (ordered << _INDEX_BITS) | ((1 << _INDEX_BITS) - 1 - index)
    idx = torch.topk(key, k, dim=-1).indices
    return x.gather(-1, idx), idx


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as uint8 (bit-exact data movement), others as is."""
    return t.view(torch.uint8) if is_float8(t.dtype) else t


def _repeat(t: torch.Tensor, K: int) -> torch.Tensor:
    """Each row repeated K times, beam-major (rows b*K .. b*K + K - 1)."""
    out = _bytes(t).repeat_interleave(K, dim=0)
    return out.view(t.dtype) if is_float8(t.dtype) else out


def _reorder_(cache: torch.Tensor, src: torch.Tensor, filled: int) -> None:
    """Rows of ``cache``'s filled prefix [0, filled) replaced by those of
    rows ``src``: gathered into a new tensor first, so no row reads one
    already overwritten."""
    data = _bytes(cache)
    data[:, :, :filled] = data[:, :, :filled].index_select(0, src)


@torch.no_grad()
def beam_decode(
    model: Whisper,
    audio_states: torch.Tensor,
    config: WhisperConfig,
    prompt: Sequence[int],
    beam_size: int = 5,
    max_len: int = 224,
    suppress_tokens: Optional[Sequence[int]] = None,
    eot: Optional[int] = None,
    length_penalty: Optional[float] = None,
    cross_kv_dtype=None,
    self_kv_dtype=None,
    xa_kv=None,
    return_beams: bool = False,
):
    """Beam-search decode from encoder states (B, T_audio, D).

    Same contract as :func:`~wealy_tpu_torch.models.whisper.generate.greedy_decode`
    (whose ``beam_size=1`` case this is): a dict with the BEST hypothesis of
    each item, ``tokens`` (B, max_len) int64, ``lengths`` (B,), ``hidden``
    (B, max_len, D) along the winning beam's own path, ``sum_logprob``
    (B,) and ``nospeech_prob`` (B,) (from the shared prefill); with
    ``return_beams=True`` also ``beam_tokens`` (B, K, max_len),
    ``beam_lengths`` (B, K) and ``beam_sum_logprob`` (B, K), best first.

    ``xa_kv``: cross K/V precomputed at batch B (the long-form ladder),
    repeated K times here.
    """
    B = audio_states.shape[0]
    K = int(beam_size)
    P = len(prompt)
    if not 0 < P < max_len:
        raise ValueError(f"prompt length {P} must be in (0, max_len={max_len})")
    if K < 1:
        raise ValueError(f"beam_size {K} must be at least 1")
    if eot is None:
        eot = config.eot
    BK = B * K
    dev = audio_states.device
    suppress = suppress_mask(config, suppress_tokens, dev)

    def step_logp(logits):
        if suppress is not None:
            logits = logits.masked_fill(suppress, float("-inf"))
        return torch.log_softmax(logits.float(), dim=-1)

    # ---- prefill at B -----------------------------------------------------------------------
    xa_kv = decode_cross_kv(model, audio_states, xa_kv, cross_kv_dtype)
    logit_weight = model.decoder.rounded_embedding()
    prompt_t = torch.tensor(list(prompt), dtype=torch.long, device=dev)
    caches_b = init_kv_caches(config, B, max_len, dtype=self_kv_dtype or model.dtype, device=dev)
    hid, logits, caches_b = model.decode(
        prompt_t[None].expand(B, P), None, kv_caches=caches_b, cache_index=0, xa_kv=xa_kv,
        logit_weight=logit_weight,
    )
    nospeech_prob = nospeech_probability(config, logits, prompt)

    # the first generated token: the top K of the prefill logits seeds K
    # distinct beams per item
    sum_logprob, tok0 = top_k_first_index(step_logp(logits[:, -1]), K)  # (B, K)
    finished = tok0 == eot

    # ---- the prefill state repeated K times into the (B*K) beam batch ------------------------
    caches = [(_repeat(k, K), _repeat(v, K)) for k, v in caches_b]
    del caches_b
    if K > 1:
        xa_kv = [(_repeat(k, K), _repeat(v, K)) for k, v in xa_kv]
    hidden_buf = torch.zeros((BK, max_len, config.n_text_state), dtype=model.dtype, device=dev)
    hidden_buf[:, :P] = hid.repeat_interleave(K, dim=0)

    # traces: tok_trace[j] = the token at position j of each (item, slot),
    # src_trace[j] = the slot each position-j slot descended from (the
    # identity beyond the last step run)
    ident = torch.arange(K, device=dev).expand(B, K)
    tok_trace = torch.full((max_len, B, K), eot, dtype=torch.long, device=dev)
    tok_trace[:P] = prompt_t[:, None, None]
    tok_trace[P] = tok0
    src_trace = ident.expand(max_len, B, K).clone()
    cur_tok = tok0.reshape(BK, 1)
    batch_base = (torch.arange(B, device=dev) * K)[:, None]  # (B, 1)
    V = logits.shape[-1]
    locked = torch.full((V,), float("-inf"), device=dev)
    locked[eot] = 0.0

    i = P
    pos = torch.full((1,), P, dtype=torch.long, device=dev)  # greedy's static-shape step
    while i < max_len - 1 and not bool(finished.all()):
        hid, logits, caches = model.decode(
            cur_tok, None, kv_caches=caches, cache_index=pos, xa_kv=xa_kv,
            logit_weight=logit_weight,
        )
        pos.add_(1)
        hidden_buf[:, i] = hid[:, 0]  # pre-reorder slot order
        logp = step_logp(logits[:, -1])  # (BK, V)
        logp = torch.where(finished.reshape(BK, 1), locked, logp)
        cand = (sum_logprob.reshape(BK, 1) + logp).reshape(B, K * V)
        sum_logprob, flat = top_k_first_index(cand, K)  # (B, K)
        src_beam, new_tok = flat // V, flat % V
        src = (batch_base + src_beam).reshape(BK)
        for k, v in caches:  # positions [0, i] are filled
            _reorder_(k, src, i + 1)
            _reorder_(v, src, i + 1)
        finished = finished.reshape(BK)[src].reshape(B, K) | (new_tok == eot)
        tok_trace[i + 1] = new_tok
        src_trace[i + 1] = src_beam
        cur_tok = new_tok.reshape(BK, 1)
        i += 1

    # ---- backtrack: the slot that held position j of each final beam --------------------------
    tok_np, src_np = tok_trace.cpu().numpy(), src_trace.cpu().numpy()
    a = np.broadcast_to(np.arange(K), (B, K)).copy()
    tokens_np = np.empty((B, K, max_len), np.int64)
    anc_np = np.empty((B, K, max_len), np.int64)
    for j in range(max_len - 1, -1, -1):
        tokens_np[:, :, j] = np.take_along_axis(tok_np[j], a, axis=1)
        anc_np[:, :, j] = a
        a = np.take_along_axis(src_np[j], a, axis=1)
    tokens = torch.from_numpy(tokens_np).to(dev).reshape(BK, max_len)
    anc = torch.from_numpy(anc_np).to(dev)
    D = hidden_buf.shape[-1]
    hidden_buf = hidden_buf.reshape(B, K, max_len, D).gather(
        1, anc[..., None].expand(B, K, max_len, D)).reshape(BK, max_len, D)

    lengths = decoded_lengths(tokens, P, eot)  # (BK,)
    # +1 counts the closing eot, whose log-prob is in sum_logprob
    score = rank_beams(sum_logprob, lengths.reshape(B, K) - P + 1, length_penalty)
    order = torch.argsort(-score, dim=1, stable=True)  # best first
    best = batch_base[:, 0] + order[:, 0]
    flat_sum = sum_logprob.reshape(BK)
    out = {
        "tokens": tokens[best],
        "lengths": lengths[best],
        "hidden": hidden_buf[best],
        "sum_logprob": flat_sum[best],
        "nospeech_prob": nospeech_prob,
    }
    if return_beams:
        perm = (batch_base + order).reshape(BK)
        out["beam_tokens"] = tokens[perm].reshape(B, K, max_len)
        out["beam_lengths"] = lengths[perm].reshape(B, K)
        out["beam_sum_logprob"] = flat_sum[perm].reshape(B, K)
    return out
