"""Embedding extraction (counterpart of ``wealy_tpu.models.whisper.extract``):
the per-song pipeline that produces the embedding taxonomy.

  x_all        encoder, full states            (n_chunks, 1500, D)
  x_concat     encoder, mean-pooled per chunk  (n_chunks, D)
  hs_last_all  decoder last hidden, per chunk  (n_chunks, max_len, D) + lengths
  hs_last_seq  decoder last hidden, flattened  (sum_len, D)
  hs_all       all decoder layers, teacher-forced over the decoded tokens
               (n_layers + 1, n_chunks, max_len, D) + lengths
  *_en         the decoder kinds with the language forced to English

All chunks of a song go through the model as one batch on the model's
device; outputs come back as float32 numpy arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
from wealy_tpu_torch.audio.mel import N_SAMPLES
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.generate import default_prompt, greedy_decode
from wealy_tpu_torch.models.whisper.model import Whisper


def chunk_waveform(audio: np.ndarray, n_samples: int = N_SAMPLES) -> np.ndarray:
    """Split a 1-D waveform into zero-padded 30 s chunks: (n_chunks, n_samples)."""
    audio = np.asarray(audio, dtype=np.float32)
    n_chunks = max(1, -(-len(audio) // n_samples))
    out = np.zeros((n_chunks, n_samples), np.float32)
    for i in range(n_chunks):
        seg = audio[i * n_samples : (i + 1) * n_samples]
        out[i, : len(seg)] = seg
    return out


@torch.no_grad()
def encoder_states(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, 3000) -> (B, 1500, D) encoder states."""
    return model.encode(mel)


def pool_states(states: torch.Tensor, pool: str = "mean") -> torch.Tensor:
    """x_concat-style pooling over time: (B, T, D) -> (B, D)."""
    if pool == "mean":
        return states.mean(dim=1)
    if pool == "max":
        return states.amax(dim=1)
    raise ValueError(f"unknown pool mode {pool!r}")


def encoder_embeddings(model: Whisper, mel: torch.Tensor, pool: str = "mean") -> torch.Tensor:
    """x_concat-style pooled encoder embedding per chunk: (B, D)."""
    return pool_states(encoder_states(model, mel), pool)


def decoder_embeddings(
    model: Whisper,
    mel: torch.Tensor,
    config: WhisperConfig,
    language: Optional[int] = None,
    max_len: int = 224,
    eot: Optional[int] = None,
    states: Optional[torch.Tensor] = None,
    cross_kv_dtype=None,
    self_kv_dtype=None,
):
    """hs_last_all-style decoder last-hidden-state embeddings per chunk
    (the :func:`greedy_decode` dict). Set ``language=0`` for the ``_en``
    variants; pass ``states`` to reuse encoder states already computed;
    ``cross_kv_dtype`` / ``self_kv_dtype`` select float8 KV storage."""
    if states is None:
        states = encoder_states(model, mel)
    prompt = default_prompt(config, language=language)
    return greedy_decode(model, states, config, prompt=prompt, max_len=max_len, eot=eot,
                         cross_kv_dtype=cross_kv_dtype, self_kv_dtype=self_kv_dtype)


def flatten_decoder_sequence(hidden: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """hs_last_seq: concatenate the valid positions of every chunk: (sum_len, D)."""
    parts = [np.asarray(hidden[i, : int(lengths[i])]) for i in range(hidden.shape[0])]
    return np.concatenate(parts, axis=0) if parts else np.zeros((0, hidden.shape[-1]))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@torch.no_grad()
def extract_song(
    model: Whisper,
    audio: np.ndarray,
    config: WhisperConfig,
    kinds: Sequence[str] = ("x_concat",),
    max_len: int = 224,
):
    """Run the per-song extraction for the requested taxonomy entries.

    ``kinds`` ⊆ {x_all, x_concat, hs_last_all, hs_last_seq, hs_all} and their
    ``_en`` decoder variants. The encoder runs once and is shared by every
    kind.
    """
    chunks = torch.from_numpy(chunk_waveform(audio)).to(model.device)
    mel = log_mel_spectrogram_fused(chunks, n_mels=config.n_mels)
    states = encoder_states(model, mel)
    out = {}
    if "x_all" in kinds:
        out["x_all"] = _np(states)
    if "x_concat" in kinds:
        out["x_concat"] = _np(pool_states(states))
    for suffix, language in (("", None), ("_en", 0)):
        wants = {f"hs_last_all{suffix}", f"hs_last_seq{suffix}", f"hs_all{suffix}"} & set(kinds)
        if not wants:
            continue
        dec = decoder_embeddings(
            model, mel, config, language=language, max_len=max_len, states=states
        )
        hidden = _np(dec["hidden"])
        lengths = dec["lengths"].cpu().numpy()
        if f"hs_last_all{suffix}" in kinds:
            out[f"hs_last_all{suffix}"] = hidden
            out[f"hs_last_all{suffix}_lengths"] = lengths
        if f"hs_last_seq{suffix}" in kinds:
            out[f"hs_last_seq{suffix}"] = flatten_decoder_sequence(hidden, lengths)
        if f"hs_all{suffix}" in kinds:
            _, _, all_h = model.decode(dec["tokens"], states, return_all_hiddens=True)
            out[f"hs_all{suffix}"] = _np(all_h)
            out[f"hs_all{suffix}_lengths"] = lengths
    return out
