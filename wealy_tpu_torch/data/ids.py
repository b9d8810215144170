"""Deterministic IDs and clique-id mappings.

Parity: lib/embedding_dataset/utils.py:7-12 (MD5 song id) and
id_mapper.py:47-106 (per-dataset hash inputs, global clique mapping with
cross-split offsets).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict

from wealy_tpu_torch.data.metadata import Metadata, SPLITS


def deterministic_song_id(clique_str: str, version_str: str) -> int:
    """MD5(f"{clique}-{version}") first 4 bytes -> positive int31."""
    combined = f"{clique_str}-{version_str}"
    hash_bytes = hashlib.md5(combined.encode("utf-8")).digest()
    return int.from_bytes(hash_bytes[:4], byteorder="big") & 0x7FFFFFFF


def _hash_inputs(md: Metadata, version_key: str) -> tuple[str, str]:
    """Per-dataset (clique_str, version_str) fed to the hash
    (id_mapper.py:47-70)."""
    entry = md.info[version_key]
    if md.dataset_name == "shs":
        if "-" not in version_key:
            raise ValueError(f"SHS version_key without '-': {version_key}")
        clique_str, version_str = version_key.split("-", 1)
        return str(clique_str), str(version_str)
    if md.dataset_name == "lyric-covers":
        return str(entry.get("clique")), str(entry.get("version_id", version_key))
    if md.dataset_name == "discogs-vi":
        version_str = str(entry.get("version_id", entry.get("base_filename", version_key)))
        return str(entry.get("clique")), version_str.replace(os.sep, "/")
    return str(entry.get("clique", "")), str(entry.get("version_id", version_key))


def assign_deterministic_ids(md: Metadata) -> None:
    """Overwrite every info entry's ``id`` with its deterministic MD5 id."""
    for version_key, entry in md.info.items():
        c, v = _hash_inputs(md, version_key)
        entry["id"] = deterministic_song_id(c, v)


def global_clique_id_mapping(md: Metadata) -> Dict[str, int]:
    """Global clique -> int mapping with cross-split offsets
    (id_mapper.py:94-106): train cliques first, then val, then test."""
    mapping: Dict[str, int] = {}
    offset = 0
    for split in SPLITS:
        for i, clique_id in enumerate(md.splits[split].keys()):
            mapping[clique_id] = offset + i
        offset += len(md.splits[split])
    return mapping
