"""Embedding extraction over a split, one song at a time, the counterpart of
``wealy_tpu.cli.extract``: audio -> 30 s chunks -> mel -> Whisper -> the
per-version store. Versions already stored are skipped (unless
``overwrite``), failures are collected for a re-run instead of raised, and
the store's missing-work lists are written to ``path.cache``. The batched
split jobs are in :mod:`wealy_tpu_torch.cli.extract_batched`."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig
from wealy_tpu_torch.models.whisper.convert import load_openai_state_dict
from wealy_tpu_torch.models.whisper.model import Whisper
from wealy_tpu_torch.utils.profiling import trace_span


def load_whisper_model(
    size: str = "tiny",
    checkpoint: Optional[str] = None,
    seed: int = 0,
    device="cuda",
    dtype=torch.bfloat16,
) -> tuple[Whisper, WhisperConfig]:
    """Build the extraction Whisper on ``device`` (the card unless the
    caller asks for the CPU): weights from an openai-whisper or HF
    checkpoint when given, otherwise a seeded random init drawn on the CPU,
    so that the card and the CPU get the same weights (no weights are
    downloaded). The build and the load are a ``whisper.load`` span."""
    cfg = WHISPER_CONFIGS[size]
    device = resolve_device(device)
    with trace_span("whisper.load"):
        model = Whisper(cfg, dtype=dtype, device=device)
        if checkpoint:
            model.load_state_dict(load_openai_state_dict(checkpoint))
        else:
            model.init_weights(torch.Generator().manual_seed(seed))
    return model.eval(), cfg


class _SongFailure:
    """The context of one song's extraction: a failure of that song alone
    (out of device memory, a store write) is recorded in ``failed`` for a
    re-run and the split goes on; any other error raises, a kernel
    wrapper's refused launch (ValueError) and a kernel fault among them."""

    PER_SONG = (torch.cuda.OutOfMemoryError, OSError)

    def __init__(self, version_key: str, failed: list, log: Callable[[str], None],
                 tag: str = "extract"):
        self.version_key, self.failed, self.log, self.tag = version_key, failed, log, tag

    def __enter__(self) -> "_SongFailure":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None or not issubclass(exc_type, self.PER_SONG):
            return False
        self.failed.append(self.version_key)
        self.log(f"[{self.tag}] FAILED {self.version_key}: {exc}")
        return True


def extract_split(
    config,
    metadata,
    split: str,
    *,
    kinds: Sequence[str] = ("x_concat", "hs_last_seq"),
    hf_checkpoint: Optional[str] = None,
    max_len: int = 224,
    limit: Optional[int] = None,
    overwrite: bool = False,
    log: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Extract the requested taxonomy entries for every version in a split,
    one song at a time through ``extract_song``, on ``device`` (the card
    unless the caller asks for the CPU).

    Returns {"done": [...], "skipped": [...], "failed": [...]}.
    """
    from wealy_tpu_torch.data.audio_dataset import AudioDataset
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.models.whisper.extract import extract_song

    model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                     device=device)
    store = EmbeddingStore(config.path.hidden_states, config.data.dataset_name)
    ds = AudioDataset(metadata, split, config.path.data)

    primary = f"{kinds[0]}.npz"
    done, skipped, failed = [], [], []
    versions = ds.versions[:limit] if limit else ds.versions
    for i, version_key in enumerate(versions):
        if not overwrite and store.exists(version_key, primary):
            skipped.append(version_key)
            continue
        item = ds[i]
        with _SongFailure(version_key, failed, log):
            out = extract_song(model, item.waveform, wcfg, kinds=kinds, max_len=max_len)
            for kind in kinds:
                arrays = {"embeddings": out[kind]}
                if f"{kind}_lengths" in out:
                    arrays["lengths"] = out[f"{kind}_lengths"]
                store.save(version_key, f"{kind}.npz", **arrays)
            done.append(version_key)
        if (i + 1) % 50 == 0:
            log(f"[extract] {i + 1}/{len(versions)} ({len(done)} new)")

    audit_dir = config.path.cache or config.path.working_dir
    if audit_dir:
        store.verify(metadata, primary, out_dir=audit_dir)
    return {"done": done, "skipped": skipped, "failed": failed}
