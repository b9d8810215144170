"""Audio / embedding path construction per dataset layout.

Parity: lib/embedding_dataset/path_manager.py (embedding paths, incl. SHS's
three candidate folder names) and filters.py:45-92 (audio paths).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

AUDIO_SUBDIR = {
    "shs": ("SHS100K", "audio"),
    "lyric-covers": ("LyricCovers", "audio"),
    "discogs-vi": ("DiscogsVI", "audio"),
}


def shs_candidate_folders(set_id: str) -> list[str]:
    """The three folder-name candidates SHS audio/embeddings may live under
    (path_manager.py:25-35)."""
    return [
        set_id,
        f"{set_id}-" if set_id.isdigit() and int(set_id) < 10 else set_id,
        set_id[:2] if len(set_id) > 2 else set_id,
    ]


def audio_base_path(dataset_name: str, data_root: str | Path) -> Path:
    sub = AUDIO_SUBDIR.get(dataset_name)
    if sub is None:
        raise ValueError(f"unsupported dataset: {dataset_name}")
    return Path(data_root).joinpath(*sub)


def find_audio_path(dataset_name: str, data_root: str | Path, version_key: str) -> Optional[Path]:
    """Return the existing audio file path for a version, or None."""
    base = audio_base_path(dataset_name, data_root)
    if dataset_name == "shs":
        if "-" not in version_key:
            return None
        set_id = version_key.split("-", 1)[0]
        for folder in shs_candidate_folders(set_id):
            p = base / folder / f"{version_key}.mp3"
            if p.exists():
                return p
        return None
    if dataset_name == "lyric-covers":
        p = base / version_key / f"{version_key}_audio.mp3"
        return p if p.exists() else None
    if dataset_name == "discogs-vi":
        p = base / f"{version_key}.mp3"
        return p if p.exists() else None
    return None


def find_embedding_path(
    dataset_name: str, hidden_states_root: str | Path, version_key: str, filename: str
) -> Optional[Path]:
    """Return the existing embedding-file path for (version, filename), or None.

    Layouts (path_manager.py:17-47): SHS nests under candidate set-id folders;
    lyric-covers is flat per version; discogs-vi mirrors its (possibly nested)
    base_filename.
    """
    root = Path(hidden_states_root)
    if dataset_name == "shs":
        if "-" not in version_key:
            return None
        set_id = version_key.split("-", 1)[0]
        for folder in shs_candidate_folders(set_id):
            p = root / folder / version_key / filename
            if p.exists():
                return p
        return None
    if dataset_name == "lyric-covers":
        p = root / version_key / filename
        return p if p.exists() else None
    if dataset_name == "discogs-vi":
        p = root / version_key.replace("/", os.sep) / filename
        return p if p.exists() else None
    return None


def embedding_filename(embedding_type: str, embedding_format: str) -> str:
    """The (type, format) -> filename taxonomy of the reference
    (base_dataset.py:99-126). Stored as .npz in this framework, with the
    reference's .pt stems preserved for familiarity."""
    key = (embedding_type, embedding_format)
    table = {
        ("encoder", "concat"): "x_concat",
        ("encoder", "all"): "x_all",
        ("hidden_states", "all"): "hs_all",
        ("last_hidden_states", "concat"): "hs_last_seq",
        ("last_hidden_states", "all"): "hs_last_all",
        ("last_hidden_states_en", "concat"): "hs_last_seq_en",
        ("last_hidden_states_en", "all"): "hs_last_all_en",
    }
    if embedding_type == "sbert":
        return "hs_sbert.npz"
    if embedding_type == "clews":
        return "hs_clews.npz"
    if embedding_type == "multimodal":
        return "multimodal"  # marker: multiple files per version
    if key not in table:
        raise ValueError(
            f"unknown embedding (type, format): {key!r}; see base_dataset.py:99-126"
        )
    return table[key] + ".npz"
