"""Split-wise metadata filters.

Parity: lib/embedding_dataset/filters.py — audio-existence, >=2-version
cliques, train/eval clique-overlap removal. Filters mutate the Metadata's
``splits`` in place; call ``metadata.prune_to_splits()`` afterwards to drop
orphaned info entries (filters.py:209-223).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

from wealy_tpu_torch.data.metadata import Metadata, SPLITS
from wealy_tpu_torch.data.paths import find_audio_path


def remove_versions_without_audio(
    md: Metadata,
    data_root: str | Path,
    exists_fn: Optional[Callable[[str], bool]] = None,
) -> Dict[str, int]:
    """Drop versions whose audio file is missing; drop cliques left empty.

    ``exists_fn`` overrides the on-disk probe (for tests / remote stores).
    Returns per-split removed counts.
    """
    removed = {}
    for split in SPLITS:
        before = sum(len(v) for v in md.splits[split].values())
        filtered = {}
        for clique_id, versions in md.splits[split].items():
            if exists_fn is not None:
                kept = [v for v in versions if exists_fn(v)]
            else:
                kept = [
                    v
                    for v in versions
                    if find_audio_path(md.dataset_name, data_root, v) is not None
                ]
            if kept:
                filtered[clique_id] = kept
        md.splits[split] = filtered
        removed[split] = before - sum(len(v) for v in filtered.values())
    return removed


def remove_single_version_cliques(md: Metadata) -> Dict[str, int]:
    """Drop cliques with fewer than 2 versions (filters.py:87-109)."""
    removed = {}
    for split in SPLITS:
        before = len(md.splits[split])
        md.splits[split] = {
            c: v for c, v in md.splits[split].items() if len(v) >= 2
        }
        removed[split] = before - len(md.splits[split])
    return removed


def remove_overlapping_cliques(md: Metadata) -> Dict[str, int]:
    """Remove val/test cliques that also appear in train (filters.py:111-130)."""
    train_cliques = set(md.splits["train"].keys())
    removed = {"train": 0}
    for split in ("val", "test"):
        before = len(md.splits[split])
        md.splits[split] = {
            c: v for c, v in md.splits[split].items() if c not in train_cliques
        }
        removed[split] = before - len(md.splits[split])
    return removed


def filter_to_available_embeddings(
    md: Metadata, exists_fn: Callable[[str], bool]
) -> Dict[str, int]:
    """Debug-mode filter: keep only versions whose embeddings exist, then drop
    single-version cliques (filters.py:132-207)."""
    removed = {}
    for split in SPLITS:
        before = sum(len(v) for v in md.splits[split].values())
        filtered = {}
        for clique_id, versions in md.splits[split].items():
            kept = [v for v in versions if exists_fn(v)]
            if len(kept) >= 2:
                filtered[clique_id] = kept
        md.splits[split] = filtered
        removed[split] = before - sum(len(v) for v in filtered.values())
    return removed
