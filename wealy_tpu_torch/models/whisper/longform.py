"""Sequential long-form transcription (counterpart of
``wealy_tpu.models.whisper.longform``): context carry-over, the
temperature-fallback ladder, compression-ratio and log-prob gates, and the
no-speech skip.

The reference's transcription trees (read at lib/audio_dataset/cache.py:46-90)
come from Whisper's published long-form algorithm, which decodes 30 s
chunks in order: each chunk's prompt is ``<|startofprev|>`` + the tail of
the text transcribed so far, and each chunk climbs a temperature ladder
while its output is degenerate (zlib compression ratio above 2.4, looping
text, or mean token log-probability below -1.0), unless p(<|nospeech|>)
says the chunk is silence.

As in the JAX package: context lengths snap down to :data:`CTX_BUCKETS`;
without a tokenizer the compression gate runs over the token ids as int32
little-endian bytes (pass ``decode_text`` for the text's bytes); a sampled
rung draws ``best_of`` candidates as one batched decode that shares the
chunk's cross-attention K/V. Sampled rungs draw from a ``torch.Generator``
seeded from ``seed`` and the rung (``c * 101 + int(t * 10)``, the JAX
package's ``fold_in`` data): the same seed repeats the same transcription,
but the draws are not the JAX package's (see ``generate.py``).
"""

from __future__ import annotations

import zlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from wealy_tpu_torch.models.whisper.beam import beam_decode
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.generate import (
    default_prompt,
    default_suppress_tokens,
    greedy_decode,
)
from wealy_tpu_torch.models.whisper.model import Whisper

# context-tail buckets; the longest useful context is 128 tokens
CTX_BUCKETS = (0, 8, 16, 32, 64, 128)
# openai-whisper's temperature-fallback ladder
TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def compression_ratio(data: bytes) -> float:
    """len(raw) / len(zlib(raw)): high for degenerately repetitive output
    (openai-whisper's gating statistic)."""
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def _ctx_bucket(n: int) -> int:
    best = 0
    for b in CTX_BUCKETS:
        if b <= n:
            best = b
    return best


def rung_seed(seed: int, chunk: int, temperature: float) -> int:
    """The seed of one chunk's sampled rung: ``seed`` combined with the JAX
    package's per-rung data ``chunk * 101 + int(temperature * 10)``."""
    return (seed * 1_000_003 + chunk * 101 + int(temperature * 10)) % (1 << 63)


@torch.no_grad()
def transcribe_longform(
    model: Whisper,
    audio_states: torch.Tensor,
    config: WhisperConfig,
    *,
    language: Optional[int] = 0,
    max_len: int = 224,
    temperatures: Sequence[float] = TEMPERATURES,
    best_of: int = 5,
    beam_size: Optional[int] = None,
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    decode_text: Optional[Callable[[Sequence[int]], str]] = None,
    seed: int = 0,
    suppress_tokens: Optional[Sequence[int]] = "default",
    initial_prompt_tokens: Optional[Sequence[int]] = None,
) -> dict:
    """Transcribe one song's encoder states (n_chunks, ctx, d) in order.

    ``best_of``: candidates drawn per t > 0 rung, the winner the largest
    summed log-probability over its token count (openai-whisper's
    ``best_of=5`` and MaximumLikelihoodRanker). The t = 0 rung decodes one
    candidate: greedy, or beam search when ``beam_size`` > 1
    (:mod:`wealy_tpu_torch.models.whisper.beam`).

    ``suppress_tokens``: ids never generated; ``"default"`` is
    openai-whisper's special set (:func:`default_suppress_tokens`), None or
    () none.

    ``initial_prompt_tokens``: openai-whisper's ``initial_prompt``, the
    first chunk's <|startofprev|> context (cyclic-padded to the smallest
    bucket when shorter); it ages out of the context like transcribed text
    and goes with a high-temperature reset.

    Returns {"chunk_tokens": per chunk its generated ids (empty when
    skipped), "segments": per chunk {temperature, avg_logprob,
    compression_ratio, no_speech_prob, context_len, skipped}, "text": the
    joined text with ``decode_text``, else None}.
    """
    n_chunks = audio_states.shape[0]
    dev = audio_states.device
    base_prompt = default_prompt(config, language=language)
    if isinstance(suppress_tokens, str) and suppress_tokens == "default":
        suppress_tokens = default_suppress_tokens(config)
    suppress_tokens = list(suppress_tokens or ())

    context: list[int] = list(initial_prompt_tokens or ())
    min_bucket = min(b for b in CTX_BUCKETS if b > 0)
    if context and len(context) < min_bucket:
        # context lengths snap DOWN to the buckets, which would drop a short
        # initial prompt; cyclic-pad it to the smallest bucket instead
        reps = -(-min_bucket // len(context))
        context = (context * reps)[-min_bucket:]
    chunk_tokens: list[list[int]] = []
    segments: list[dict] = []

    for c in range(n_chunks):
        states = audio_states[c : c + 1]
        # the cross-attention K/V depend only on the audio: made once a
        # chunk, in f32 as the decode holds them, shared by every rung
        chunk_xa_kv = [(k.float(), v.float()) for k, v in model.precompute_cross_kv(states)]
        n_ctx = _ctx_bucket(len(context))
        ctx_tail = context[-n_ctx:] if n_ctx else []
        prompt = (([config.token_startofprev] + ctx_tail) if ctx_tail else []) + base_prompt

        # the budget is max_len NEW tokens however long the carried context
        # (openai-whisper's sample_len); the buffer caps at the decoder's context
        total_len = min(config.n_text_ctx, len(prompt) + max_len)
        chosen = None
        for t in temperatures:
            use_beam = t == 0.0 and beam_size is not None and beam_size > 1
            n_cand = 1 if t == 0.0 else max(1, int(best_of))
            states_t = states.expand(n_cand, *states.shape[1:])
            xa_kv_t = [(k.expand(n_cand, *k.shape[1:]), v.expand(n_cand, *v.shape[1:]))
                       for k, v in chunk_xa_kv]
            if use_beam:
                out = beam_decode(
                    model, states_t, config, prompt=prompt, beam_size=int(beam_size),
                    max_len=total_len, suppress_tokens=suppress_tokens, xa_kv=xa_kv_t,
                )
            else:
                gen = None
                if t != 0.0:
                    gen = torch.Generator(device=dev).manual_seed(rung_seed(seed, c, t))
                out = greedy_decode(
                    model, states_t, config, prompt=prompt, max_len=total_len,
                    suppress_tokens=suppress_tokens, temperature=float(t), generator=gen,
                    xa_kv=xa_kv_t,
                )
            lengths_np = out["lengths"].cpu().numpy()
            sumlp_np = out["sum_logprob"].float().cpu().numpy()
            nospeech = out["nospeech_prob"].float().cpu().numpy()
            # the candidates' ranking: summed log-prob over token count
            n_gen_all = np.maximum(lengths_np - len(prompt), 1)
            best = int(np.argmax(sumlp_np / n_gen_all)) if n_cand > 1 else 0
            length = int(lengths_np[best])
            gen_toks = out["tokens"][best, len(prompt) : length].tolist()
            n_gen = max(length - len(prompt), 0)
            avg_logprob = float(sumlp_np[best]) / (n_gen + 1)
            if decode_text is not None:
                payload = decode_text(gen_toks).encode("utf-8")
            else:
                payload = np.asarray(gen_toks, "<i4").tobytes()
            ratio = compression_ratio(payload)

            needs_fallback = False
            if compression_ratio_threshold is not None and ratio > compression_ratio_threshold:
                needs_fallback = True  # looping output
            if logprob_threshold is not None and avg_logprob < logprob_threshold:
                needs_fallback = True  # low-confidence output
            if no_speech_threshold is not None and float(nospeech[best]) > no_speech_threshold:
                # confident silence: keep this result and let the gate below
                # skip the chunk (openai-whisper's no-speech early exit)
                needs_fallback = False
            chosen = {
                "tokens": gen_toks,
                "temperature": float(t),
                "avg_logprob": avg_logprob,
                "compression_ratio": ratio,
                "no_speech_prob": float(nospeech[best]),
            }
            if not needs_fallback:
                break
        if chosen is None:
            raise ValueError("transcribe_longform: no temperatures to decode with")

        # the voice-activity gate: confident silence skips the chunk
        skipped = False
        if (
            no_speech_threshold is not None
            and chosen["no_speech_prob"] > no_speech_threshold
            and (logprob_threshold is None or chosen["avg_logprob"] < logprob_threshold)
        ):
            skipped = True
            chosen["tokens"] = []

        chunk_tokens.append(chosen["tokens"])
        segments.append({
            "temperature": chosen["temperature"],
            "avg_logprob": chosen["avg_logprob"],
            "compression_ratio": chosen["compression_ratio"],
            "no_speech_prob": chosen["no_speech_prob"],
            "context_len": len(ctx_tail),
            "skipped": skipped,
        })

        # context carry-over; a high-temperature rescue resets the context
        if not condition_on_previous_text or chosen["temperature"] > 0.5:
            context = []
        elif not skipped:
            context = (context + chosen["tokens"])[-max(CTX_BUCKETS):]

    text = None
    if decode_text is not None:
        text = " ".join(decode_text(toks).strip() for toks in chunk_tokens if toks).strip()
    return {"chunk_tokens": chunk_tokens, "segments": segments, "text": text}
