"""The embedding-dataset pipeline, a copy of ``wealy_tpu.data.dataset``:
``build_clean_dataset`` (metadata -> filters -> deterministic ids ->
embedding verification -> processed cache) and ``EmbeddingDataset`` (the
sampler-backed dataset over stored embeddings, preferring a packed store).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from wealy_tpu_torch.data.embedding_store import EmbeddingStore
from wealy_tpu_torch.data.filters import (
    filter_to_available_embeddings,
    remove_overlapping_cliques,
    remove_single_version_cliques,
    remove_versions_without_audio,
)
from wealy_tpu_torch.data.ids import assign_deterministic_ids, global_clique_id_mapping
from wealy_tpu_torch.data.metadata import SPLITS, Metadata, load_metadata
from wealy_tpu_torch.data.packed_store import PackedStore
from wealy_tpu_torch.data.paths import embedding_filename
from wealy_tpu_torch.data.sampler import CliqueSampler
from wealy_tpu_torch.train.config import Config


def processed_cache_path(config: Config, debug: bool = False) -> Optional[Path]:
    """{cache}/{dataset}/processed_dataset_{type}_{format}[_debug].json"""
    cache_root = config.path.cache or config.path.working_dir
    if not cache_root:
        return None
    suffix = "_debug" if debug else ""
    return (
        Path(cache_root)
        / config.data.dataset_name
        / f"processed_dataset_{config.data.embedding_type}_{config.data.embedding_format}{suffix}.json"
    )


def validate_data_structures(md: Metadata, split: str) -> Dict:
    """Consistency report: every split version has an info entry; counts per
    clique."""
    versions = md.versions_in_split(split)
    missing_info = [v for v in versions if v not in md.info]
    clique_sizes = {c: len(v) for c, v in md.splits[split].items()}
    return {
        "split": split,
        "n_cliques": len(md.splits[split]),
        "n_versions": len(versions),
        "missing_info": missing_info,
        "single_version_cliques": [c for c, n in clique_sizes.items() if n < 2],
        "ok": not missing_info,
    }


def ensure_perfect_consistency(md: Metadata, split: str) -> None:
    """Prune split cliques to versions with info entries and >= 2 versions;
    raise ValueError if an inconsistency survives (discogs-vi's invariant)."""
    pruned = {}
    for clique_id, versions in md.splits[split].items():
        valid = [v for v in versions if v in md.info]
        if len(valid) >= 2:
            pruned[clique_id] = valid
    md.splits[split] = pruned
    report = validate_data_structures(md, split)
    if not report["ok"] or report["single_version_cliques"]:
        raise ValueError(f"dataset inconsistency after pruning ({split}): {report}")


def build_clean_dataset(
    config: Config,
    *,
    debug: bool = False,
    check_audio: bool = False,
    verbose: bool = False,
    store: Optional[EmbeddingStore] = None,
    log: Callable[[str], None] = print,
    refresh_cache: bool = False,
) -> tuple[Metadata, Dict[str, int]]:
    """(metadata, global clique2id): processed cache -> meta cache / CSVs ->
    [audio filter] -> single-version filter -> overlap filter -> [debug
    embedding filter] -> prune info -> deterministic ids -> embedding
    verification (gates the processed-cache write) -> global clique mapping.
    ``refresh_cache`` skips reading the processed cache."""
    cache_path = processed_cache_path(config, debug)
    if cache_path and cache_path.exists() and not refresh_cache:
        payload = json.loads(cache_path.read_text())
        md = Metadata(
            dataset_name=payload["dataset_name"], info=payload["info"], splits=payload["splits"]
        )
        return md, payload["clique2id"]

    md = load_metadata(
        config.data.dataset_name,
        shs_data=config.path.shs_data,
        shs_splits=config.path.shs_splits,
        lyric_covers_data=config.path.lyric_covers_data,
        discogs_vi_data=config.path.discogs_vi_data,
        meta_cache=config.path.meta,
    )
    if check_audio and config.path.data:
        removed = remove_versions_without_audio(md, config.path.data)
        if verbose:
            log(f"audio filter removed: {removed}")
    remove_single_version_cliques(md)
    remove_overlapping_cliques(md)

    store = store or (
        EmbeddingStore(config.path.hidden_states, config.data.dataset_name)
        if config.path.hidden_states else None
    )
    filename = embedding_filename(config.data.embedding_type, config.data.embedding_format)
    if debug and store is not None and filename != "multimodal":
        filter_to_available_embeddings(md, lambda v: store.exists(v, filename))

    md.prune_to_splits()
    assign_deterministic_ids(md)

    all_verified = True
    if store is not None and filename != "multimodal":
        missing = store.verify(md, filename, out_dir=cache_path.parent if cache_path else None)
        n_missing = sum(len(v) for v in missing.values())
        all_verified = n_missing == 0
        if verbose and n_missing:
            log(f"embedding verification: {n_missing} missing files")

    clique2id = global_clique_id_mapping(md)
    if cache_path and all_verified:  # cache only a fully verified dataset
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        cache_path.write_text(json.dumps({
            "dataset_name": md.dataset_name,
            "info": md.info,
            "splits": md.splits,
            "clique2id": clique2id,
        }))
    return md, clique2id


class EmbeddingDataset:
    """Dataset over precomputed embeddings, sampler-backed. ``limit_cliques``
    keeps the split's first N cliques (the reference's LIMIT_CLIQUES);
    ``n_per_class`` overrides ``config.data.n_per_class``."""

    def __init__(
        self,
        config: Config,
        split: str = "train",
        *,
        n_per_class: Optional[int] = None,
        debug: bool = False,
        limit_cliques: Optional[int] = None,
        check_audio: bool = False,
        verbose: bool = False,
        seed: int = 0,
        store: Optional[EmbeddingStore] = None,
        refresh_cache: bool = False,
    ):
        if split not in SPLITS:
            raise ValueError(f"unknown split {split!r}; expected one of {SPLITS}")
        self.config = config
        self.split = split
        self.store = store or (
            EmbeddingStore(config.path.hidden_states, config.data.dataset_name)
            if config.path.hidden_states else None
        )
        self.filename = embedding_filename(
            config.data.embedding_type, config.data.embedding_format
        )
        # the packed memory-mapped store, when present and not older than the
        # per-version files it was packed from; unpacked versions fall through
        self.packed = None
        if config.path.hidden_states:
            packed = PackedStore(
                config.path.hidden_states, self.filename, dataset_name=config.data.dataset_name
            )
            if packed.available:
                probe = list(packed.keys())[:64]
                if packed.newer_files_exist(self.store, self.filename, probe):
                    logging.getLogger(__name__).warning(
                        "pack %s is older than re-extracted per-version files — ignoring it",
                        packed.bin_path,
                    )
                else:
                    self.packed = packed
        self.metadata, self.clique2id = build_clean_dataset(
            config, debug=debug, check_audio=check_audio, verbose=verbose,
            store=self.store, refresh_cache=refresh_cache,
        )
        if limit_cliques is not None:
            keep = list(self.metadata.splits[split].keys())[:limit_cliques]
            self.metadata.splits[split] = {c: self.metadata.splits[split][c] for c in keep}
        if config.data.dataset_name == "discogs-vi":
            ensure_perfect_consistency(self.metadata, split)
        self.report = validate_data_structures(self.metadata, split)
        self.sampler = CliqueSampler(
            self.metadata, split, self.load_embedding,
            n_per_class=n_per_class if n_per_class is not None else config.data.n_per_class,
            p_samesong=config.data.p_samesong,
            augment=config.data.augment,
            seed=seed,
        )

    def load_embedding(self, version_key: str) -> Optional[np.ndarray]:
        """Main embedding array of a version, fp32 (packed store first)."""
        if self.packed is not None:
            emb = self.packed.load(version_key)
            if emb is not None:
                return emb
        if self.store is None:
            return None
        data = self.store.load(version_key, self.filename)
        if data is None:
            return None
        return data["embeddings"] if "embeddings" in data else next(iter(data.values()))

    def __len__(self) -> int:
        return len(self.sampler)

    def __getitem__(self, index: int):
        return self.sampler.sample_item(index)
