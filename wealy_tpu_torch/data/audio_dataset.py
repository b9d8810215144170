"""Raw-audio dataset stack: audio + transcription items feeding the
batched extraction, a copy of ``wealy_tpu.data.audio_dataset``.

Parity: lib/audio_dataset/dataset.py (AudioDataset) and dataloader.py:
  - items carry (clique_idx, version_idx, waveform, transcription,
    has_valid_transcription, audio_path) (dataset.py:594-675)
  - decode failures degrade to a 1 s dummy silence waveform, never crash
    (dataset.py:645-661)
  - ``evaluation_mode`` skips audio decode and exposes candidate id arrays
    (dataset.py:436-467)
  - collate pads to the batch max (optionally hard-capped at 300 s / 16 kHz)
    and builds a True=valid attention mask; malformed items are dropped
    (dataloader.py:10-137)
  - the loader can install SIGINT/SIGTERM handlers and supports
    ``debug_num_cliques`` subsetting (dataloader.py:139-253)

The collate can also pad to length *buckets* instead of the exact batch max,
bounding the set of shapes the mel and encoder see. Everything here is host
numpy; decode runs on the host (:mod:`wealy_tpu_torch.audio.decode`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from wealy_tpu_torch.audio.decode import load_audio
from wealy_tpu_torch.audio.mel import SAMPLE_RATE
from wealy_tpu_torch.data.metadata import SPLITS, Metadata
from wealy_tpu_torch.data.paths import find_audio_path
from wealy_tpu_torch.data.transcription import TranscriptionCache, TranscriptionValidator

MAX_AUDIO_SECONDS = 300  # dataloader.py:18
DUMMY_SILENCE_SECONDS = 1


@dataclasses.dataclass
class AudioItem:
    clique_idx: int
    version_idx: int
    waveform: Optional[np.ndarray]
    transcription: Optional[str]
    has_valid_transcription: bool
    audio_path: Optional[str]
    version_key: str


class AudioDataset:
    """Map-style dataset over one split of {shs, lyric-covers, discogs-vi}."""

    def __init__(
        self,
        metadata: Metadata,
        split: str,
        data_root: str | Path,
        *,
        transcription_cache: Optional[TranscriptionCache] = None,
        validator: Optional[TranscriptionValidator] = None,
        evaluation_mode: bool = False,
        debug_num_cliques: Optional[int] = None,
        sample_rate: int = SAMPLE_RATE,
    ):
        assert split in SPLITS
        self.metadata = metadata
        self.split = split
        self.data_root = Path(data_root)
        self.cache = transcription_cache
        self.validator = validator or TranscriptionValidator(
            min_words=10, max_repetition_ratio=0.6
        )
        self.evaluation_mode = evaluation_mode
        self.sample_rate = sample_rate

        cliques = list(metadata.splits[split].items())
        if debug_num_cliques is not None:
            cliques = cliques[:debug_num_cliques]
        self.versions: List[str] = [v for _, vs in cliques for v in vs]
        self._clique_idx = {
            v: metadata.info[v]["clique_idx"] for v in self.versions
        }

    def __len__(self) -> int:
        return len(self.versions)

    def check_clique_versions(self) -> Dict:
        """Post-init clique integrity stats (dataset.py:505-554)."""
        sizes: Dict[str, int] = {}
        for clique_id, versions in self.metadata.splits[self.split].items():
            sizes[clique_id] = len(versions)
        small = [c for c, n in sizes.items() if n < 2]
        return {
            "n_cliques": len(sizes),
            "n_versions": sum(sizes.values()),
            "single_version_cliques": small,
            "ok": not small,
        }

    def evaluation_tensors(self) -> Dict[str, np.ndarray]:
        """Candidate id arrays for retrieval eval (dataset.py:436-467)."""
        clique_idx = np.array(
            [self.metadata.info[v]["clique_idx"] for v in self.versions], np.int64
        )
        version_idx = np.array(
            [self.metadata.info[v]["version_idx"] for v in self.versions], np.int64
        )
        return {"clique_idx": clique_idx, "version_idx": version_idx}

    def _transcription_for(self, version_key: str):
        if self.cache is None:
            return None, False
        text = self.cache.get(version_key)
        if text is None:
            return None, False
        return text, self.validator.is_valid_transcription(text)

    def __getitem__(self, index: int) -> AudioItem:
        version_key = self.versions[index]
        entry = self.metadata.info[version_key]
        path = find_audio_path(self.metadata.dataset_name, self.data_root, version_key)
        text, valid = self._transcription_for(version_key)

        waveform = None
        if not self.evaluation_mode:
            if path is not None:
                # a host decode that fails, whatever the cause, degrades to
                # silence below; no card call happens here
                with contextlib.suppress(Exception):
                    waveform = load_audio(path, sr=self.sample_rate)
            if waveform is None or len(waveform) == 0:
                # degrade-and-continue: dummy silence (dataset.py:645-661)
                waveform = np.zeros(
                    DUMMY_SILENCE_SECONDS * self.sample_rate, np.float32
                )
        return AudioItem(
            clique_idx=int(entry["clique_idx"]),
            version_idx=int(entry["version_idx"]),
            waveform=waveform,
            transcription=text,
            has_valid_transcription=valid,
            audio_path=str(path) if path is not None else None,
            version_key=version_key,
        )


def _bucket_length(n: int, buckets: Optional[Sequence[int]]) -> int:
    if not buckets:
        return n
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


def audio_collate(
    items: Sequence[AudioItem],
    enforce_max_duration: bool = False,
    max_seconds: int = MAX_AUDIO_SECONDS,
    sample_rate: int = SAMPLE_RATE,
    length_buckets: Optional[Sequence[int]] = None,
) -> Dict:
    """Pad waveforms to the batch max (or cap / bucket), mask True=valid.

    Malformed items (no waveform) are dropped; an empty batch yields empty
    arrays rather than raising (dataloader.py:24-68 defensive semantics).
    """
    good = [it for it in items if it.waveform is not None and len(it.waveform) > 0]
    if not good:
        return {
            "clique_ids": np.zeros((0,), np.int64),
            "version_ids": np.zeros((0,), np.int64),
            "waveforms": np.zeros((0, 0), np.float32),
            "lengths": np.zeros((0,), np.int64),
            "attention_mask": np.zeros((0, 0), bool),
            "transcriptions": [],
            "valid_flags": np.zeros((0,), bool),
            "audio_paths": [],
            "version_keys": [],
        }
    cap = max_seconds * sample_rate
    lengths = [
        min(len(it.waveform), cap) if enforce_max_duration else len(it.waveform)
        for it in good
    ]
    T = _bucket_length(max(lengths), length_buckets)
    B = len(good)
    waveforms = np.zeros((B, T), np.float32)
    mask = np.zeros((B, T), bool)
    for i, (it, L) in enumerate(zip(good, lengths)):
        L = min(L, T)
        waveforms[i, :L] = it.waveform[:L]
        mask[i, :L] = True
    return {
        "clique_ids": np.array([it.clique_idx for it in good], np.int64),
        "version_ids": np.array([it.version_idx for it in good], np.int64),
        "waveforms": waveforms,
        "lengths": np.array(lengths, np.int64),
        "attention_mask": mask,
        "transcriptions": [it.transcription for it in good],
        "valid_flags": np.array([it.has_valid_transcription for it in good], bool),
        "audio_paths": [it.audio_path for it in good],
        "version_keys": [it.version_key for it in good],
    }


def create_audio_loader(
    dataset: AudioDataset,
    batch_size: int = 8,
    shuffle: Optional[bool] = None,
    drop_last: Optional[bool] = None,
    seed: int = 0,
    install_signal_handlers: bool = False,
    **collate_kwargs,
) -> Iterator[Dict]:
    """Batched iterator over the dataset with train/eval defaults
    (shuffle/drop_last only for train — dataloader.py:231-234)."""
    is_train = dataset.split == "train"
    shuffle = is_train if shuffle is None else shuffle
    drop_last = is_train if drop_last is None else drop_last

    if install_signal_handlers:
        # graceful shutdown (dataloader.py:184-188)
        def _handler(signum, frame):
            raise KeyboardInterrupt(f"signal {signum}")

        signal.signal(signal.SIGINT, _handler)
        signal.signal(signal.SIGTERM, _handler)

    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = len(order) - (len(order) % batch_size) if drop_last else len(order)
    for start in range(0, end, batch_size):
        idxs = order[start : start + batch_size]
        if len(idxs) == 0:
            continue
        yield audio_collate([dataset[int(i)] for i in idxs], **collate_kwargs)
