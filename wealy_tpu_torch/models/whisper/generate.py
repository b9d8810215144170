"""Greedy decoding with a KV cache (counterpart of
``wealy_tpu.models.whisper.generate``, temperature 0 only).

The extraction path for the decoder-embedding taxonomy (``hs_last_seq`` /
``hs_last_all``): transcribe each 30 s chunk greedily and keep the decoder's
last hidden state for every position. The step loop is a Python loop that
stops as soon as every row has emitted <|endoftext|> (one host sync per
step); buffers are static (``max_len``) so the outputs match the JAX ones.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.model import Whisper


def default_prompt(config: WhisperConfig, language: Optional[int] = None) -> list[int]:
    """<|startoftranscript|> [<|lang|> <|transcribe|>] <|notimestamps|>.

    ``language=None`` omits the language/task tokens; ``language=0`` forces
    English — the ``_en`` embedding variants.
    """
    toks = [config.sot]
    if language is not None:
        toks += [config.language_token(language), config.token_transcribe]
    toks.append(config.token_no_timestamps)
    return toks


def init_kv_caches(
    config: WhisperConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
):
    """Per-layer self-attention caches: k (pre-scaled) and v, each
    (B, H, max_len, Dh). ``Whisper.decode`` writes them in place."""
    H = config.n_text_head
    Dh = config.n_text_state // H
    return [
        (
            torch.zeros((batch, H, max_len, Dh), dtype=dtype, device=device),
            torch.zeros((batch, H, max_len, Dh), dtype=dtype, device=device),
        )
        for _ in range(config.n_text_layer)
    ]


@torch.no_grad()
def greedy_decode(
    model: Whisper,
    audio_states: torch.Tensor,
    config: WhisperConfig,
    prompt: Sequence[int],
    max_len: int = 224,
    suppress_tokens: Optional[Sequence[int]] = None,
    eot: Optional[int] = None,
):
    """Greedy decode from encoder states.

    Returns dict with:
      - ``tokens``  (B, max_len) int64 — prompt + generated, eot-padded
      - ``lengths`` (B,) int64 — number of valid positions (incl. prompt)
      - ``hidden``  (B, max_len, D) — decoder last hidden state per position
      - ``sum_logprob`` (B,) f32 — sum of log p(chosen token) over generated
        tokens incl. the closing eot
      - ``nospeech_prob`` (B,) f32 — p(<|nospeech|>) at the <|sot|> position
    """
    B = audio_states.shape[0]
    P = len(prompt)
    if not 0 < P < max_len:
        raise ValueError(f"prompt length {P} must be in (0, max_len={max_len})")
    if eot is None:
        eot = config.eot
    dev = audio_states.device

    tokens = torch.full((B, max_len), eot, dtype=torch.long, device=dev)
    tokens[:, :P] = torch.tensor(list(prompt), dtype=torch.long, device=dev)
    hidden_buf = torch.zeros((B, max_len, config.n_text_state), dtype=model.dtype, device=dev)
    caches = init_kv_caches(config, B, max_len, dtype=model.dtype, device=dev)
    if suppress_tokens:
        suppress = torch.zeros(config.n_vocab, dtype=torch.bool, device=dev)
        suppress[torch.tensor(list(suppress_tokens), dtype=torch.long, device=dev)] = True
    else:
        suppress = None

    def choose(logits):
        """(B, V) logits -> (next token, its log-probability), suppressed
        tokens masked to -inf first."""
        if suppress is not None:
            logits = logits.masked_fill(suppress, float("-inf"))
        logp = torch.log_softmax(logits.float(), dim=-1)
        nxt = torch.argmax(logits, dim=-1)
        return nxt, logp.gather(-1, nxt[:, None])[:, 0]

    # per-step operands made once: the cross-attention K/V and the logit
    # embedding, rounded to the compute dtype and held in f32 (the step
    # multiplies them in f32 anyway)
    xa_kv = [(k.float(), v.float()) for k, v in model.precompute_cross_kv(audio_states)]
    logit_weight = model.decoder.rounded_embedding()
    hid, logits, caches = model.decode(
        tokens[:, :P], None, kv_caches=caches, cache_index=0, xa_kv=xa_kv,
        logit_weight=logit_weight,
    )
    hidden_buf[:, :P] = hid
    # p(<|nospeech|>) at the LAST <|sot|> of the prompt
    sot_index = P - 1 - list(prompt)[::-1].index(config.sot) if config.sot in prompt else 0
    sot_logp = torch.log_softmax(logits[:, sot_index].float(), dim=-1)
    # a vocabulary too small to hold the special tokens (test configs) reads
    # the last entry, as the JAX gather clamps its index
    nospeech = min(config.token_nospeech, sot_logp.shape[-1] - 1)
    nospeech_prob = torch.exp(sot_logp[:, nospeech])

    next_tok, sum_logprob = choose(logits[:, -1])
    tokens[:, P] = next_tok
    finished = next_tok == eot

    i = P
    while i < max_len - 1 and not bool(finished.all()):
        hid, logits, caches = model.decode(
            tokens[:, i : i + 1], None, kv_caches=caches, cache_index=i, xa_kv=xa_kv,
            logit_weight=logit_weight,
        )
        hidden_buf[:, i] = hid[:, 0]
        nxt, logp = choose(logits[:, -1])
        nxt = torch.where(finished, eot, nxt)
        sum_logprob = sum_logprob + torch.where(finished, 0.0, logp)
        tokens[:, i + 1] = nxt
        finished = finished | (nxt == eot)
        i += 1

    # lengths: prompt + generated tokens before the first eot
    pos = torch.arange(max_len, device=dev)[None, :]
    is_eot = (tokens == eot) & (pos >= P)
    lengths = torch.where(
        is_eot.any(dim=1), is_eot.int().argmax(dim=1), torch.full_like(tokens[:, 0], max_len)
    )
    return {
        "tokens": tokens,
        "lengths": lengths,
        "hidden": hidden_buf,
        "sum_logprob": sum_logprob,
        "nospeech_prob": nospeech_prob,
    }
