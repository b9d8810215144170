"""Transcription over a split (counterpart of ``wealy_tpu.cli.transcribe``):
audio -> Whisper decode -> ``.txt`` files + the validity census.

It writes what the reference's transcription stack reads
(lib/audio_dataset/cache.py: ``{root}/{whisper_set}/.../{key}.txt``), then
indexes the tree with :class:`TranscriptionCache` and runs the
:class:`TranscriptionValidator` census beside it.

- :func:`transcribe_split`: one song at a time; by default Whisper's
  long-form algorithm (:mod:`wealy_tpu_torch.models.whisper.longform`),
  with ``longform=False`` one greedy (or beam) decode of all the song's
  chunks.
- :func:`transcribe_split_batched`: chunks of many songs per device batch
  through :func:`make_transcribe_fn` (mel K1 -> encoder K2/K3 -> greedy or
  beam decode). A partial last batch is decoded at its own size, not padded
  to ``batch_size`` (the JAX driver pads for one compile; rows do not
  depend on the batch's other rows either way). On a mesh every rank runs
  the same batches, each decodes its rows of a batch that divides the
  ``data`` axis (the rows gathered; another batch runs whole), and only
  the primary rank writes the files and the census.

Token ids become text through the offline byte-level BPE
(:mod:`wealy_tpu_torch.data.tokenizer`) when a vocabulary directory is
given; without one the job writes token-id lines. Every entry point runs on
the card unless ``device="cpu"``. A song's own failure (out of device
memory, a file write) is recorded in ``failed`` and the split goes on; any
other error raises, a kernel wrapper's refused launch among them (the JAX
package records every exception of a song).
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
from wealy_tpu_torch.cli.extract import _SongFailure, load_whisper_model
from wealy_tpu_torch.cli.extract_batched import _batches, _chunks
from wealy_tpu_torch.data.audio_dataset import AudioDataset
from wealy_tpu_torch.data.tokenizer import ByteLevelBPE
from wealy_tpu_torch.data.transcription import TranscriptionCache, TranscriptionValidator
from wealy_tpu_torch.models.whisper.beam import beam_decode
from wealy_tpu_torch.models.whisper.extract import chunk_waveform
from wealy_tpu_torch.models.whisper.generate import (
    default_prompt,
    default_suppress_tokens,
    greedy_decode,
)
from wealy_tpu_torch.models.whisper.longform import transcribe_longform
from wealy_tpu_torch.parallel.mesh import barrier, shard_rows
from wealy_tpu_torch.utils.profiling import ThroughputMeter


def _transcription_root(config, split: str) -> Path:
    root = (Path(config.path.cache or config.path.working_dir or ".") / "transcriptions"
            / config.data.whisper_set / split)
    root.mkdir(parents=True, exist_ok=True)
    return root


def _text(ids, tokenizer) -> str:
    """A chunk's generated ids as text, or as an id line without a tokenizer."""
    ids = [int(t) for t in ids]
    if tokenizer is not None:
        return tokenizer.decode(ids)
    return " ".join(str(t) for t in ids)


def _decode(model, states, wcfg, prompt, max_len, suppress, beam_size):
    """Greedy, or beam search with ``beam_size`` > 1, of every row."""
    if beam_size is not None and beam_size > 1:
        return beam_decode(model, states, wcfg, prompt=prompt, beam_size=int(beam_size),
                           max_len=max_len, suppress_tokens=suppress)
    return greedy_decode(model, states, wcfg, prompt=prompt, max_len=max_len,
                         suppress_tokens=suppress)


def transcribe_split(
    config,
    metadata,
    split: str,
    *,
    tokenizer_dir: Optional[str] = None,
    language: Optional[int] = 0,
    max_len: int = 224,
    limit: Optional[int] = None,
    overwrite: bool = False,
    hf_checkpoint: Optional[str] = None,
    longform: bool = True,
    beam_size: Optional[int] = None,
    initial_prompt: Optional[str] = None,
    log: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Transcribe every version of a split into the reference .txt layout
    and run the validity census, on ``device`` (the card unless the caller
    asks for the CPU). Returns {done, skipped, failed, n_valid, n_total,
    cache_file}.

    ``beam_size`` (> 1) runs beam search on the deterministic rung (the
    long-form t = 0 rung, or the per-chunk decode); ``initial_prompt``
    (long-form, needs a tokenizer) seeds the first chunk's context. Decoding
    suppresses openai-whisper's default set: the task specials always, the
    non-speech symbols when a tokenizer can name them."""
    device = resolve_device(device)
    model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                     device=device)
    tokenizer = ByteLevelBPE.from_dir(tokenizer_dir) if tokenizer_dir else None
    suppress = default_suppress_tokens(wcfg, tokenizer)
    init_toks = None
    if initial_prompt:
        if tokenizer is None:
            raise ValueError("--initial-prompt requires --tokenizer-dir")
        init_toks = tokenizer.encode(" " + initial_prompt.strip())
    ds = AudioDataset(metadata, split, config.path.data)
    root = _transcription_root(config, split)
    prompt = default_prompt(wcfg, language=language)

    done, skipped, failed = [], [], []
    versions = ds.versions[:limit] if limit else ds.versions
    index_of = {v: i for i, v in enumerate(ds.versions)}
    for version_key in versions:
        out_path = root / f"{version_key.replace('/', '__')}.txt"
        if out_path.exists() and not overwrite:
            skipped.append(version_key)
            continue
        item = ds[index_of[version_key]]
        with _SongFailure(version_key, failed, log, tag="transcribe"):
            with torch.inference_mode():
                chunks = torch.from_numpy(chunk_waveform(item.waveform)).to(device)
                enc = model.encode(log_mel_spectrogram_fused(chunks, n_mels=wcfg.n_mels))
                if longform:
                    res = transcribe_longform(
                        model, enc, wcfg, language=language, max_len=max_len,
                        beam_size=beam_size, suppress_tokens=suppress,
                        initial_prompt_tokens=init_toks,
                        decode_text=((lambda ids: tokenizer.decode(list(ids)))
                                     if tokenizer is not None else None),
                        seed=zlib.crc32(version_key.encode()) & 0x7FFFFFFF,
                    )
                    if tokenizer is not None:
                        pieces = [res["text"] or ""]
                    else:
                        pieces = [_text(toks, None) for toks in res["chunk_tokens"]]
                else:
                    out = _decode(model, enc, wcfg, prompt, max_len, suppress, beam_size)
                    tokens, lengths = out["tokens"].cpu().numpy(), out["lengths"].cpu().numpy()
                    pieces = [_text(tokens[c, len(prompt) : int(lengths[c])], tokenizer)
                              for c in range(tokens.shape[0])]
            out_path.write_text(" ".join(p.strip() for p in pieces).strip() + "\n")
            done.append(version_key)

    return _census_result(config, root, split, versions, done, skipped, failed)


def _census_result(config, root, split, versions, done, skipped, failed) -> dict:
    """Index the .txt tree and run the validity census (shared by the
    sequential and batched drivers)."""
    cache = TranscriptionCache(root.parent, config.data.dataset_name, config.data.whisper_set,
                               split)
    cache.build_index(root)
    census = cache.validate_all(
        [v.replace("/", "__") for v in versions],
        TranscriptionValidator(min_words=10, max_repetition_ratio=0.6),
    )
    cache.save_disk_cache()
    n_valid = sum(1 for c in census.values() if c["has_valid_transcription"])
    return {
        "done": done,
        "skipped": skipped,
        "failed": failed,
        "n_valid": n_valid,
        "n_total": len(versions),
        "cache_file": str(cache.cache_file),
    }


def make_transcribe_fn(config, hf_checkpoint=None, *, language: Optional[int] = 0,
                       max_len: int = 224, mesh=None, beam_size: Optional[int] = None,
                       tokenizer=None, device=None):
    """The batched device path: mel (K1) -> Whisper encoder (K2, K3) ->
    greedy decode, or beam search with ``beam_size`` > 1 (the beams of each
    chunk ride the batch). ``fn(audio (B, 480000)) -> (tokens (B,
    max_len), lengths (B,))`` on ``device``; ``fn.prompt_len`` is the
    prompt's length. ``mesh``: a batch whose rows divide its ``data`` axis
    shards over the ranks and the outputs are gathered (``shard_rows``);
    the model lives on the mesh's card."""
    device = resolve_device(device) if mesh is None else mesh.device
    model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                     device=device)
    prompt = default_prompt(wcfg, language=language)
    suppress = default_suppress_tokens(wcfg, tokenizer)

    @torch.inference_mode()
    def fn(audio):
        mel = log_mel_spectrogram_fused(_chunks(audio, device), n_mels=wcfg.n_mels)
        out = _decode(model, model.encode(mel), wcfg, prompt, max_len, suppress, beam_size)
        return out["tokens"], out["lengths"]

    fn = shard_rows(mesh, fn)
    fn.prompt_len = len(prompt)
    return fn


def transcribe_split_batched(
    config,
    metadata,
    split: str,
    transcribe_fn=None,
    *,
    tokenizer_dir: Optional[str] = None,
    language: Optional[int] = 0,
    max_len: int = 224,
    batch_size: int = 16,
    mesh=None,
    limit: Optional[int] = None,
    overwrite: bool = False,
    hf_checkpoint: Optional[str] = None,
    n_workers: int = 4,
    beam_size: Optional[int] = None,
    log: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Cross-song batched transcription (greedy or beam per chunk): 30 s
    chunks of many songs share device batches as in
    ``extract_split_batched``, with the host decode running ahead on
    threads; each song's ``{key}.txt`` is written as soon as its last chunk
    is decoded. ``transcribe_fn`` defaults to :func:`make_transcribe_fn` on
    ``device``, built at the first batch (a run that skips every song loads
    no model). Long-form decoding stays on :func:`transcribe_split` (its
    chunk-to-chunk prompt serialises each song).

    Returns the census dict (on a mesh, the primary rank's; the others have
    no census: ``n_valid`` None) plus "incomplete" and "throughput"."""
    tokenizer = ByteLevelBPE.from_dir(tokenizer_dir) if tokenizer_dir else None
    primary = mesh is None or mesh.is_primary
    ds = AudioDataset(metadata, split, config.path.data)
    root = _transcription_root(config, split)

    def out_path(v: str) -> Path:
        return root / f"{v.replace('/', '__')}.txt"

    if limit:
        ds.versions = ds.versions[:limit]
    versions = list(ds.versions)
    skipped = []
    if not overwrite:
        skipped = [v for v in versions if out_path(v).exists()]
        ds.versions = [v for v in versions if not out_path(v).exists()]
    barrier(mesh)  # every rank takes the same schedule before the primary writes

    meter = ThroughputMeter(window=20, n_chips=1 if mesh is None else mesh.world_size)
    pieces: dict = {}  # version -> per chunk its token ids (None until decoded)
    done: list = []
    failed: list = []

    def finish(version_key: str) -> None:
        text = " ".join(_text(ids, tokenizer).strip() for ids in pieces.pop(version_key))
        with _SongFailure(version_key, failed, log, tag="transcribe-batched"):
            if primary:
                out_path(version_key).write_text(text.strip() + "\n")
            done.append(version_key)

    for batch in _batches(ds, batch_size, n_workers):
        if transcribe_fn is None:
            transcribe_fn = make_transcribe_fn(
                config, hf_checkpoint, language=language, max_len=max_len, mesh=mesh,
                beam_size=beam_size, tokenizer=tokenizer, device=device,
            )
        prompt_len = getattr(transcribe_fn, "prompt_len", 0)
        audio = torch.from_numpy(np.stack([chunk for _, _, _, chunk in batch]))
        tokens, lengths = (np.asarray(torch.as_tensor(a).cpu()) for a in transcribe_fn(audio))
        meter.tick(len(batch))
        for (version_key, chunk_idx, n_chunks, _), row, L in zip(batch, tokens, lengths):
            acc = pieces.setdefault(version_key, [None] * n_chunks)
            acc[chunk_idx] = row[prompt_len : int(L)]
            if all(p is not None for p in acc):
                finish(version_key)
        if done and len(done) % 200 == 0:
            log(f"[transcribe-batched] {len(done)} songs, {meter.items_per_sec:.1f} chunks/s")

    if primary:
        result = _census_result(config, root, split, versions, done, skipped, failed)
    else:  # the primary rank writes the census
        result = {"done": done, "skipped": skipped, "failed": failed, "n_valid": None,
                  "n_total": len(versions), "cache_file": None}
    result["incomplete"] = sorted(pieces)
    result["throughput"] = meter.report()
    return result
