"""Multimodal embedding datasets, WEALY+CLEWS and Whisper+CLEWS: a copy of
``wealy_tpu.data.multimodal``.

- WEALY+CLEWS loads per version ``hs_wealy_concat`` ({embeddings
  (n_chunks, zdim), chunk_info, extraction_method}, or a legacy raw
  array), ``hs_clews`` (116, 2048), ``hs_clews_avg`` (2048,) and
  ``hs_clews_mask`` (116,) bool (True = INVALID, ops convention), each
  with a dummy of the canonical shape when the file is missing. Every dummy
  is recorded in ``dummy_log`` as ``"<version>:<what>"``.
- Whisper+CLEWS loads ``hs_last_seq`` (seq_len, 1280) and the CLEWS trio;
  the whisper mask is all valid.
- Versions are ordered by their deterministic id
  (:func:`ensure_version_alignment`, :func:`aligned_versions`).

Packed stores (``pack --kind <file>``) are read first, one per file.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from wealy_tpu_torch.data.dataset import EmbeddingDataset
from wealy_tpu_torch.data.metadata import SPLITS, Metadata
from wealy_tpu_torch.train.config import Config

CLEWS_SEQ_LEN = 116
CLEWS_DIM = 2048
WHISPER_DIM = 1280
DUMMY_WEALY_CHUNKS = 10
DUMMY_WHISPER_LEN = 15

WEALY_FILES = ("hs_wealy_concat.npz", "hs_clews.npz", "hs_clews_avg.npz", "hs_clews_mask.npz")
WHISPER_FILES = ("hs_last_seq.npz", "hs_clews.npz", "hs_clews_avg.npz", "hs_clews_mask.npz")


def ensure_version_alignment(md: Metadata, split: str) -> None:
    """Sort each clique's version list by deterministic id, so the order is
    the same across runs."""
    for clique_id, versions in md.splits[split].items():
        md.splits[split][clique_id] = sorted(versions, key=lambda v: int(md.info[v]["id"]))


def aligned_versions(md: Metadata, split: str) -> List[str]:
    """The flat version list sorted globally by deterministic id (item
    ``idx`` follows the id order, not the clique grouping)."""
    flat = [v for versions in md.splits[split].values() for v in versions]
    return sorted(flat, key=lambda v: int(md.info[v]["id"]))


class MultimodalEmbeddingDataset(EmbeddingDataset):
    """Base of the two multimodal datasets; the sampler loads each version's
    multimodal dict (:meth:`load_multimodal`)."""

    FILES: tuple = ()

    def __init__(self, config: Config, split: str = "train", **kwargs):
        self.dummy_log: List[str] = []
        self._packs: dict = {}
        super().__init__(config, split, **kwargs)
        ensure_version_alignment(self.metadata, split)
        # the sampler over the aligned order, loading multimodal dicts
        self.sampler.load_fn = self.load_multimodal
        self.sampler.versions = aligned_versions(self.metadata, split)
        self.sampler.clique_of = {
            v: c for c, versions in self.metadata.splits[split].items() for v in versions
        }

    # -- loading --------------------------------------------------------
    def _packed_load(self, version_key: str, filename: str):
        """The version's row of the pack of ``filename``, or None (no pack,
        a pack older than re-extracted files, or a version not in it)."""
        from wealy_tpu_torch.data.packed_store import PackedStore

        if filename not in self._packs:
            root = self.config.path.hidden_states
            pack = PackedStore(root, filename, dataset_name=self.config.data.dataset_name) \
                if root else None
            if pack is not None and pack.available:
                probe = list(pack.keys())[:64]
                if pack.newer_files_exist(self.store, filename, probe):
                    logging.getLogger(__name__).warning(
                        "pack %s is older than re-extracted per-version files — ignoring it; "
                        "run `pack` to refresh", pack.bin_path)
                    pack = None
            self._packs[filename] = pack
        pack = self._packs[filename]
        if pack is None or not pack.available:
            return None
        return pack.load(version_key)

    def _load_array(self, version_key: str, filename: str, key: str = "embeddings"):
        packed = self._packed_load(version_key, filename)
        if packed is not None:
            return packed
        data = self.store.load(version_key, filename) if self.store else None
        if data is None:
            return None
        return data[key] if key in data else next(iter(data.values()))

    def _dummy(self, version_key: str, what: str, arr: np.ndarray) -> np.ndarray:
        self.dummy_log.append(f"{version_key}:{what}")
        return arr

    def _load_clews_trio(self, version_key: str):
        full = self._load_array(version_key, "hs_clews.npz")
        if full is None:
            full = self._dummy(version_key, "full_clews",
                               np.zeros((CLEWS_SEQ_LEN, CLEWS_DIM), np.float32))
        avg = self._load_array(version_key, "hs_clews_avg.npz")
        if avg is None:
            avg = self._dummy(version_key, "avg_clews", np.zeros((CLEWS_DIM,), np.float32))
        mask = self._load_array(version_key, "hs_clews_mask.npz")
        if mask is None:
            # the dummy mask is all True: every position INVALID
            mask = self._dummy(version_key, "clews_mask", np.ones((CLEWS_SEQ_LEN,), bool))
        return full, avg, np.asarray(mask, bool)

    def load_multimodal(self, version_key: str) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # -- verification ---------------------------------------------------
    def verify_embeddings_exist(self) -> Dict[str, List[str]]:
        """The versions of each split without the modality's primary file
        (the CLEWS files are optional: they have dummies)."""
        primary = self.FILES[0]
        return {
            split: [v for versions in self.metadata.splits[split].values() for v in versions
                    if not self.store.exists(v, primary)]
            for split in SPLITS
        }


class WealyClewsDataset(MultimodalEmbeddingDataset):
    """Per item: {wealy: {embeddings, chunk_info, extraction_method},
    full_clews, avg_clews, clews_mask}."""

    FILES = WEALY_FILES

    def load_multimodal(self, version_key: str) -> Dict[str, np.ndarray]:
        packed = self._packed_load(version_key, "hs_wealy_concat.npz")
        if packed is not None:
            packed = np.atleast_2d(packed)
            wealy = {
                "embeddings": packed,
                "chunk_info": {"total_chunks": int(packed.shape[0])},
                "extraction_method": "packed",
            }
        else:
            wealy = self.store.load(version_key, "hs_wealy_concat.npz") if self.store else None
        zdim = self.config.model.zdim
        if wealy is None:
            wealy = {
                "embeddings": self._dummy(version_key, "wealy",
                                          np.zeros((DUMMY_WEALY_CHUNKS, zdim), np.float32)),
                "chunk_info": {"total_chunks": DUMMY_WEALY_CHUNKS},
                "extraction_method": "dummy",
            }
        elif "embeddings" not in wealy:
            # a legacy raw-array file
            raw = next(iter(wealy.values()))
            if raw.ndim == 1:
                raw = raw[None]
            wealy = {
                "embeddings": raw.astype(np.float32),
                "chunk_info": {"total_chunks": raw.shape[0]},
                "extraction_method": "legacy_format",
            }
        else:
            wealy = {
                "embeddings": np.asarray(wealy["embeddings"], np.float32),
                "chunk_info": wealy.get("chunk_info",
                                        {"total_chunks": wealy["embeddings"].shape[0]}),
                "extraction_method": wealy.get("extraction_method", "concat"),
            }
        full, avg, mask = self._load_clews_trio(version_key)
        return {"wealy": wealy, "full_clews": full, "avg_clews": avg, "clews_mask": mask}


class WhisperClewsDataset(MultimodalEmbeddingDataset):
    """Per item: {whisper_seq (T, 1280), whisper_mask (T,) all valid,
    full_clews, avg_clews, clews_mask}."""

    FILES = WHISPER_FILES

    def load_multimodal(self, version_key: str) -> Dict[str, np.ndarray]:
        seq = self._load_array(version_key, "hs_last_seq.npz")
        if seq is None:
            seq = self._dummy(version_key, "whisper_seq",
                              np.zeros((DUMMY_WHISPER_LEN, WHISPER_DIM), np.float32))
        full, avg, mask = self._load_clews_trio(version_key)
        return {
            "whisper_seq": np.asarray(seq, np.float32),
            "whisper_mask": np.zeros((seq.shape[0],), bool),  # ops convention: False = valid
            "full_clews": full,
            "avg_clews": avg,
            "clews_mask": mask,
        }
