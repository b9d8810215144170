"""Decoding with a KV cache (counterpart of
``wealy_tpu.models.whisper.generate``): greedy at temperature 0, sampling
above it, language identification and openai-whisper's default suppression
set.

The extraction path for the decoder-embedding taxonomy (``hs_last_seq`` /
``hs_last_all``) transcribes each 30 s chunk greedily and keeps the
decoder's last hidden state for every position; the long-form ladder
(:mod:`wealy_tpu_torch.models.whisper.longform`) also samples. The prompt
is one prefill call; then every step is one static-shape step (:func:`_step`,
the JAX package's maths under ``lax.while_loop``): its position is a device
scalar that the step advances, the token and the position row are read and
the new k/v, hidden state and token written by device index, and
self-attention reads the whole ``max_len`` cache under a -inf mask past
the position. Buffers are static (``max_len``) so the outputs match the
JAX ones. The step loop is a Python loop that stops as soon as every row
has emitted <|endoftext|> (one host sync per step). Each step is a
``whisper.decode_step`` span (``utils/profiling.py``) whose ``n`` is 1 when
the step was a CUDA graph replay and 0 when it ran eagerly.

Greedy decodes (temperature 0) on the current CUDA device by a decoder
without a tensor-parallel context replay the step as one CUDA graph:
captured on the first call of a signature (batch, ``max_len``, cross-K/V
shape, storage dtypes, eot, whether a suppress mask is given, and the
decoder's parameter storage) after a warm-up on a side stream, and kept on
the model with the buffers it reads, which later calls of the signature
refill (one graphed decode of a model at a time; :func:`release_step_graph`
frees them). Elsewhere (the CPU, ``parallel/tp.py::tp_decode_fn``, whose
collectives stay out of graphs, and sampling) the same step runs eagerly.

Sampling draws from an explicit ``torch.Generator`` on the decode's
device (Gumbel-max over ``logits / temperature``). It cannot reproduce
``jax.random.categorical``'s bits: the same seed repeats the same draws in
this package, and the draws follow softmax(logits / T), but they are not
the JAX package's draws. Temperature 0 is exact argmax, as there.
"""

from __future__ import annotations

import contextlib
import threading
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


class _Buffers:
    """What the static-shape step reads and writes, at fixed addresses:
    ``tokens`` (B, max_len) int64, ``hidden`` (B, max_len, D), the
    self-attention ``caches``, the cross K/V ``xa_kv`` and the f32
    ``logit_weight`` (the embedding rounded to the compute dtype);
    ``suppress`` (V,) bool or None; ``finished`` (B,) bool, ``sum_logprob``
    (B,) f32 and ``pos`` (1,) int64, the position of the step's input token.
    ``xa_kv`` and ``suppress`` are held as given."""

    __slots__ = ("tokens", "hidden", "caches", "xa_kv", "logit_weight", "suppress", "finished",
                 "sum_logprob", "pos")

    def __init__(self, model: Whisper, config: WhisperConfig, B: int, max_len: int, xa_kv,
                 self_kv_dtype, suppress):
        dev = xa_kv[0][0].device
        self.tokens = torch.empty((B, max_len), dtype=torch.long, device=dev)
        self.hidden = torch.empty((B, max_len, config.n_text_state), dtype=model.dtype, device=dev)
        self.caches = init_kv_caches(config, B, max_len, dtype=self_kv_dtype or model.dtype,
                                     device=dev, n_head=model.decoder.blocks[0].attn.n_head)
        self.xa_kv = xa_kv
        self.logit_weight = model.decoder.rounded_embedding()
        self.suppress = suppress
        self.finished = torch.zeros(B, dtype=torch.bool, device=dev)
        self.sum_logprob = torch.zeros(B, dtype=torch.float32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.long, device=dev)

    def refill(self, model: Whisper, xa_kv, suppress) -> None:
        """Copy a new call's operands in: the cross K/V (``xa_kv``, in the
        compute dtype or f32, cast as :func:`decode_cross_kv` casts), the
        rounded embedding and the suppress mask."""
        for (dk, dv), (k, v) in zip(self.xa_kv, xa_kv):
            dk.copy_(k)
            dv.copy_(v)
        self.logit_weight.copy_(model.decoder.token_embedding.weight.to(model.dtype))
        if suppress is not None:
            self.suppress.copy_(suppress)

    def start(self, prompt: Sequence[int], eot: int) -> None:
        """Reset for a decode: the prompt, then eot; hidden and caches zero."""
        self.tokens.fill_(eot)
        self.tokens[:, : len(prompt)] = torch.tensor(list(prompt), dtype=torch.long,
                                                     device=self.tokens.device)
        self.hidden.zero_()
        for ck, cv in self.caches:
            ck.zero_()
            cv.zero_()


def _step(model: Whisper, s: _Buffers, eot: int, temperature: float = 0.0,
          generator: Optional[torch.Generator] = None) -> None:
    """One decode step at the device position ``s.pos``: the token there
    through the decoder against the whole cache, its hidden state kept, the
    next token written after it (eot in finished rows, whose log-probability
    no longer counts), ``finished`` updated and ``s.pos`` advanced. Static
    shapes and no host sync, so it can be captured as a CUDA graph."""
    hid, logits, _ = model.decode(
        s.tokens.index_select(1, s.pos), None, kv_caches=s.caches, cache_index=s.pos,
        xa_kv=s.xa_kv, logit_weight=s.logit_weight,
    )
    s.hidden.index_copy_(1, s.pos, hid)
    nxt, logp = choose_tokens(logits[:, -1], temperature, generator, s.suppress)
    nxt = torch.where(s.finished, eot, nxt)
    s.sum_logprob.add_(torch.where(s.finished, 0.0, logp))
    s.tokens.index_copy_(1, s.pos + 1, nxt[:, None])
    s.finished.logical_or_(nxt == eot)
    s.pos.add_(1)


def _graphable(model: Whisper, dev: torch.device, temperature: float) -> bool:
    """Whether the step is replayed as a CUDA graph: greedy, on the current
    CUDA device, by a decoder with no tensor-parallel context (whose
    collectives stay out of graphs)."""
    return (temperature == 0.0 and dev.type == "cuda"
            and dev.index == torch.cuda.current_device()
            and model.decoder.blocks[0].attn.tp is None)


def _capture(model: Whisper, s: _Buffers, eot: int) -> torch.cuda.CUDAGraph:
    """A CUDA graph of one greedy step over ``s``, captured after two warm-up
    steps on a side stream (they write position 1; :meth:`_Buffers.start`
    clears them). Thread-local capture: the feed's threads may use the card
    meanwhile."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            s.pos.zero_()
            _step(model, s, eot)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        _step(model, s, eot)
    return graph


class _HeldGraph:
    """A model's step graph, kept as ``model._greedy_graph``: its ``key``
    (the signature it was captured for), ``buffers`` and ``graph`` (None
    until a capture and after :func:`release_step_graph`), and the ``lock``
    that a graphed decode holds from its refill to the copies it returns,
    since request threads (the serve daemon's) may share one model."""

    __slots__ = ("lock", "key", "buffers", "graph")

    def __init__(self):
        self.lock = threading.Lock()
        self.key = self.buffers = self.graph = None

    def take(self, model: Whisper, config: WhisperConfig, audio_states, prompt, max_len: int,
             eot: int, xa_kv, cross_kv_dtype, self_kv_dtype, suppress):
        """(buffers, graph) for this call's signature, its operands copied
        in: the held ones when the signature is the held one, else captured
        anew (the old one's memory freed first). The held cross K/V and
        suppress mask are the graph's own, never a caller's tensors. Call
        with ``lock`` held."""
        if xa_kv is None:
            xa_kv = model.precompute_cross_kv(audio_states)
        key = (audio_states.shape[0], tuple(xa_kv[0][0].shape), max_len, eot, cross_kv_dtype,
               self_kv_dtype, suppress is not None,
               tuple(p.data_ptr() for p in model.decoder.parameters()))
        if self.key != key:
            self.key = self.buffers = self.graph = None
            dev = audio_states.device
            # plain tensors, not inference ones: the buffers outlive a caller's inference mode
            with torch.inference_mode(False), torch.no_grad():
                held_kv = [tuple(torch.empty(t.shape, dtype=cross_kv_dtype or torch.float32,
                                             device=dev) for t in kv) for kv in xa_kv]
                s = _Buffers(model, config, audio_states.shape[0], max_len, held_kv,
                             self_kv_dtype, None if suppress is None else suppress.clone())
            s.refill(model, xa_kv, suppress)
            s.start(prompt, eot)  # valid tokens for the warm-up steps
            self.graph, self.buffers, self.key = _capture(model, s, eot), s, key
        else:
            self.buffers.refill(model, xa_kv, suppress)
        return self.buffers, self.graph


_HOLDING = threading.Lock()  # makes each model's _HeldGraph once


def _held(model: Whisper) -> _HeldGraph:
    """``model._greedy_graph``, made on first use."""
    with _HOLDING:
        if getattr(model, "_greedy_graph", None) is None:
            model._greedy_graph = _HeldGraph()
        return model._greedy_graph


def release_step_graph(model: Whisper) -> None:
    """Free the step graph and the buffers ``model`` holds for
    :func:`greedy_decode` (after any decode that is replaying it); the next
    graphed call captures again."""
    held = getattr(model, "_greedy_graph", None)
    if held is not None:
        with held.lock:
            held.key = held.buffers = held.graph = None


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

    On a CUDA device at temperature 0 the steps replay one CUDA graph (the
    module docstring); the returned tensors are copies, not the buffers the
    next call overwrites. Graphed decodes of one model run one at a time.
    The graph and its buffers stay on the model until another signature
    replaces them or :func:`release_step_graph` frees them: at large-v3-turbo
    width, B=16 and ``max_len`` 224 about 1.3 GB (the f32 cross K/V 983 MB,
    the f32 logit table 266 MB, the caches and hidden states).

    Returns dict with:
      - ``tokens``  (B, max_len) int64 — prompt + generated, eot-padded
      - ``lengths`` (B,) int64 — number of valid positions (incl. prompt)
      - ``hidden``  (B, max_len, D) — decoder last hidden state per position
      - ``sum_logprob`` (B,) f32 — sum of log p(chosen token) over generated
        tokens incl. the closing eot (at temperature 1: the long-form
        avg_logprob numerator)
      - ``nospeech_prob`` (B,) f32 — p(<|nospeech|>) at the <|sot|> position
    """
    P = len(prompt)
    if not 0 < P < max_len:
        raise ValueError(f"prompt length {P} must be in (0, max_len={max_len})")
    if eot is None:
        eot = config.eot
    dev = audio_states.device
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    suppress = suppress_mask(config, suppress_tokens, dev)

    held = _held(model) if _graphable(model, dev, temperature) else None
    with contextlib.nullcontext() if held is None else held.lock:
        if held is None:
            s, graph = _Buffers(model, config, audio_states.shape[0], max_len,
                                decode_cross_kv(model, audio_states, xa_kv, cross_kv_dtype),
                                self_kv_dtype, suppress), None
        else:
            s, graph = held.take(model, config, audio_states, prompt, max_len, eot, xa_kv,
                                 cross_kv_dtype, self_kv_dtype, suppress)
        s.start(prompt, eot)

        hid, logits, _ = model.decode(
            s.tokens[:, :P], None, kv_caches=s.caches, cache_index=0, xa_kv=s.xa_kv,
            logit_weight=s.logit_weight,
        )
        s.hidden[:, :P] = hid
        nospeech_prob = nospeech_probability(config, logits, prompt)
        next_tok, logp = choose_tokens(logits[:, -1], temperature, generator, s.suppress)
        s.tokens[:, P] = next_tok
        s.finished.copy_(next_tok == eot)
        s.sum_logprob.copy_(logp)
        s.pos.fill_(P)

        # each step's span closes after its one host sync (``finished.all()``)
        i = P
        running = i < max_len - 1 and not bool(s.finished.all())
        while running:
            with trace_span("whisper.decode_step") as span:
                if graph is None:
                    _step(model, s, eot, temperature, generator)
                else:
                    graph.replay()
                span.n = int(graph is not None)
                i += 1
                running = i < max_len - 1 and not bool(s.finished.all())

        tokens, hidden, sum_logprob = s.tokens, s.hidden, s.sum_logprob
        if graph is not None:
            tokens, hidden, sum_logprob = tokens.clone(), hidden.clone(), sum_logprob.clone()
    return {
        "tokens": tokens,
        "lengths": decoded_lengths(tokens, P, eot),
        "hidden": hidden,
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
