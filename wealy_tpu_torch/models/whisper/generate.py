"""Decoding with a KV cache (counterpart of
``wealy_tpu.models.whisper.generate``): greedy at temperature 0, sampling
above it, language identification and openai-whisper's default suppression
set.

The extraction path for the decoder-embedding taxonomy (``hs_last_seq`` /
``hs_last_all``) transcribes each 30 s chunk greedily and keeps the
decoder's last hidden state for every position; the long-form ladder
(:mod:`wealy_tpu_torch.models.whisper.longform`) also samples. The step loop
is a Python loop that stops as soon as every row has emitted
<|endoftext|> (one host sync per step); buffers are static (``max_len``)
so the outputs match the JAX ones. Each step is a ``whisper.decode_step``
span (``utils/profiling.py``).

Sampling draws from an explicit ``torch.Generator`` on the decode's
device (Gumbel-max over ``logits / temperature``). It cannot reproduce
``jax.random.categorical``'s bits: the same seed repeats the same draws in
this package, and the draws follow softmax(logits / T), but they are not
the JAX package's draws. Temperature 0 is exact argmax, as there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.model import Whisper
from wealy_tpu_torch.utils.profiling import trace_span


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


def default_suppress_tokens(config: WhisperConfig, tokenizer=None) -> list[int]:
    """openai-whisper's default ``suppress_tokens="-1"`` list: the task and
    prompt special tokens, and (with a tokenizer to map them) the
    non-speech symbol tokens (brackets, quote runs, ♪) that the model
    otherwise emits over music (whisper/tokenizer.py ``non_speech_tokens``
    upstream). Ids outside the vocabulary are dropped."""
    ids = {
        config.sot,
        config.token_translate,
        config.token_transcribe,
        config.token_startoflm,
        config.token_startofprev,
        config.token_nospeech,
    }
    if tokenizer is not None:
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] "
            "{{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")
        for text in (" -", " '"):
            enc = tokenizer.encode(text)
            if enc:
                ids.add(enc[0])
        for symbol in symbols + list(miscellaneous):
            for enc in (tokenizer.encode(symbol), tokenizer.encode(" " + symbol)):
                if len(enc) == 1 or symbol in miscellaneous:
                    if enc:
                        ids.add(enc[0])
    return sorted(t for t in ids if t < config.n_vocab)


def init_kv_caches(
    config: WhisperConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
    n_head: Optional[int] = None,
):
    """Per-layer self-attention caches: k (pre-scaled) and v, each
    (B, H, max_len, Dh), at ``dtype`` (float8 for the opt-in storage).
    ``Whisper.decode`` writes them in place. ``n_head``: the heads a
    tensor-parallel rank holds (default the config's)."""
    Dh = config.n_text_state // config.n_text_head
    H = config.n_text_head if n_head is None else n_head
    return [
        (
            torch.zeros((batch, H, max_len, Dh), dtype=dtype, device=device),
            torch.zeros((batch, H, max_len, Dh), dtype=dtype, device=device),
        )
        for _ in range(config.n_text_layer)
    ]


@torch.no_grad()
def detect_language(model: Whisper, audio_states: torch.Tensor, config: WhisperConfig):
    """Whisper language identification: one teacher-forced decoder step
    from <|sot|>, logits restricted to the language-token block.

    Returns (lang_index (B,) int64, 0 is English, and the (B, n_languages)
    f32 log-probabilities)."""
    B = audio_states.shape[0]
    sot = torch.full((B, 1), config.sot, dtype=torch.long, device=audio_states.device)
    _, logits = model.decode(sot, audio_states)
    first = config.language_token(0)
    logp = torch.log_softmax(logits[:, 0, first : first + config.n_languages].float(), dim=-1)
    return logp.argmax(dim=-1), logp


def suppress_mask(config: WhisperConfig, suppress_tokens, device) -> Optional[torch.Tensor]:
    """(V,) bool mask of the token ids never generated, or None."""
    if not suppress_tokens:
        return None
    mask = torch.zeros(config.n_vocab, dtype=torch.bool, device=device)
    mask[torch.tensor(list(suppress_tokens), dtype=torch.long, device=device)] = True
    return mask


def decode_cross_kv(model: Whisper, audio_states, xa_kv=None, cross_kv_dtype=None):
    """The per-step cross-attention K/V of a decode: ``xa_kv`` (or the
    model's from ``audio_states``) stored at ``cross_kv_dtype`` when it is
    given (float8: cast from the compute dtype, upcast at every read), else
    held in f32, made once (the step multiplies in f32 anyway)."""
    if xa_kv is None:
        xa_kv = model.precompute_cross_kv(audio_states)
    if cross_kv_dtype is not None:
        return [(k.to(cross_kv_dtype), v.to(cross_kv_dtype)) for k, v in xa_kv]
    return [(k.float(), v.float()) for k, v in xa_kv]


def choose_tokens(logits: torch.Tensor, temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  suppress: Optional[torch.Tensor] = None):
    """(B, V) step logits -> (next token (B,), its log-probability (B,)
    f32), the ``suppress`` mask's tokens set to -inf first. Temperature 0
    takes the argmax (the first of equal maxima); above it a draw from
    softmax(logits / temperature) by Gumbel-max on ``generator``. The
    log-probability is always that of the untempered softmax."""
    if suppress is not None:
        logits = logits.masked_fill(suppress, float("-inf"))
    logp = torch.log_softmax(logits.float(), dim=-1)
    if temperature == 0.0:
        nxt = torch.argmax(logits, dim=-1)
    else:
        # argmax(logits / T + G), G = -log(-log(U)) Gumbel; U = 0 gives
        # G = -inf, and a masked token stays -inf, so it is never drawn
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        nxt = torch.argmax(logits.float() / temperature - torch.log(-torch.log(u)), dim=-1)
    return nxt, logp.gather(-1, nxt[:, None])[:, 0]


def nospeech_probability(config: WhisperConfig, logits: torch.Tensor, prompt) -> torch.Tensor:
    """(B,) p(<|nospeech|>) of the prefill logits at the prompt's LAST
    <|sot|> (a carried context may hold a sampled one; 0 without one). A
    vocabulary too small to hold the special tokens (test configs) reads
    the last entry, as the JAX gather clamps its index."""
    prompt = list(prompt)
    sot = len(prompt) - 1 - prompt[::-1].index(config.sot) if config.sot in prompt else 0
    logp = torch.log_softmax(logits[:, sot].float(), dim=-1)
    return torch.exp(logp[:, min(config.token_nospeech, logp.shape[-1] - 1)])


@torch.no_grad()
def greedy_decode(
    model: Whisper,
    audio_states: torch.Tensor,
    config: WhisperConfig,
    prompt: Sequence[int],
    max_len: int = 224,
    suppress_tokens: Optional[Sequence[int]] = None,
    eot: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    cross_kv_dtype=None,
    self_kv_dtype=None,
    xa_kv=None,
):
    """Decode from encoder states: greedy at ``temperature=0`` (default),
    sampling from softmax(logits / temperature) otherwise, with draws from
    ``generator`` (on the decode's device; seed 0 when None).

    ``xa_kv``: precomputed cross-attention K/V (``Whisper.precompute_cross_kv``),
    passed when the same audio is decoded several times (the long-form
    ladder); ``audio_states`` then only sets the batch and the device.
    ``cross_kv_dtype`` / ``self_kv_dtype``: float8 storage of the cross K/V
    and of the self-attention caches (the opt-in decode-bandwidth modes):
    values are cast into the storage dtype and upcast at every read.

    Returns dict with:
      - ``tokens``  (B, max_len) int64 — prompt + generated, eot-padded
      - ``lengths`` (B,) int64 — number of valid positions (incl. prompt)
      - ``hidden``  (B, max_len, D) — decoder last hidden state per position
      - ``sum_logprob`` (B,) f32 — sum of log p(chosen token) over generated
        tokens incl. the closing eot (at temperature 1: the long-form
        avg_logprob numerator)
      - ``nospeech_prob`` (B,) f32 — p(<|nospeech|>) at the <|sot|> position
    """
    B = audio_states.shape[0]
    P = len(prompt)
    if not 0 < P < max_len:
        raise ValueError(f"prompt length {P} must be in (0, max_len={max_len})")
    if eot is None:
        eot = config.eot
    dev = audio_states.device
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    tokens = torch.full((B, max_len), eot, dtype=torch.long, device=dev)
    tokens[:, :P] = torch.tensor(list(prompt), dtype=torch.long, device=dev)
    hidden_buf = torch.zeros((B, max_len, config.n_text_state), dtype=model.dtype, device=dev)
    caches = init_kv_caches(config, B, max_len, dtype=self_kv_dtype or model.dtype, device=dev,
                            n_head=model.decoder.blocks[0].attn.n_head)
    suppress = suppress_mask(config, suppress_tokens, dev)

    # per-step operands made once: the cross-attention K/V and the logit
    # embedding, rounded to the compute dtype and held in f32
    xa_kv = decode_cross_kv(model, audio_states, xa_kv, cross_kv_dtype)
    logit_weight = model.decoder.rounded_embedding()
    hid, logits, caches = model.decode(
        tokens[:, :P], None, kv_caches=caches, cache_index=0, xa_kv=xa_kv,
        logit_weight=logit_weight,
    )
    hidden_buf[:, :P] = hid
    nospeech_prob = nospeech_probability(config, logits, prompt)

    next_tok, sum_logprob = choose_tokens(logits[:, -1], temperature, generator, suppress)
    tokens[:, P] = next_tok
    finished = next_tok == eot

    # each step's span closes after its one host sync (``finished.all()``)
    i = P
    running = i < max_len - 1 and not bool(finished.all())
    while running:
        with trace_span("whisper.decode_step"):
            hid, logits, caches = model.decode(
                tokens[:, i : i + 1], None, kv_caches=caches, cache_index=i, xa_kv=xa_kv,
                logit_weight=logit_weight,
            )
            hidden_buf[:, i] = hid[:, 0]
            nxt, logp = choose_tokens(logits[:, -1], temperature, generator, suppress)
            nxt = torch.where(finished, eot, nxt)
            sum_logprob = sum_logprob + torch.where(finished, 0.0, logp)
            tokens[:, i + 1] = nxt
            finished = finished | (nxt == eot)
            i += 1
            running = i < max_len - 1 and not bool(finished.all())

    return {
        "tokens": tokens,
        "lengths": decoded_lengths(tokens, P, eot),
        "hidden": hidden_buf,
        "sum_logprob": sum_logprob,
        "nospeech_prob": nospeech_prob,
    }


def decoded_lengths(tokens: torch.Tensor, P: int, eot: int) -> torch.Tensor:
    """(N,) prompt + generated tokens before the first eot after the prompt
    (``max_len`` where there is none)."""
    max_len = tokens.shape[1]
    pos = torch.arange(max_len, device=tokens.device)[None, :]
    is_eot = (tokens == eot) & (pos >= P)
    return torch.where(
        is_eot.any(dim=1), is_eot.int().argmax(dim=1), torch.full_like(tokens[:, 0], max_len)
    )
