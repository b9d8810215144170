"""Embedding store: per-version ``.npz`` files (fp16 on disk, fp32 in
memory), the counterpart of ``wealy_tpu.data.embedding_store``.

The read side resolves the reference's layout (SHS set-id folders,
lyric-covers flat, discogs-vi nested) and, where the ``.npz`` is absent,
reads the reference's torch ``.pt`` file of the same stem: a raw tensor
becomes ``{"embeddings": array}``, a dict keeps its keys. A missing or
corrupt file loads as None (missing work), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import pickle
import zipfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from wealy_tpu_torch.data.metadata import SPLITS, Metadata
from wealy_tpu_torch.data.paths import find_embedding_path

# what a truncated or corrupt .npz / .pt raises on load
_CORRUPT = (OSError, ValueError, RuntimeError, EOFError, pickle.UnpicklingError,
            zipfile.BadZipFile)


def _upcast(a: np.ndarray) -> np.ndarray:
    """fp16 on disk -> fp32 in memory."""
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float32)
    return a


def load_pt(path: str | Path) -> Dict[str, np.ndarray]:
    """One reference ``.pt`` embedding file in the store's dict layout."""
    obj = None
    with contextlib.suppress(*_CORRUPT):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    if obj is None:
        # legacy pickled payloads (dicts with tuples / strings) need the general
        # unpickler; these are the dataset's own files, not checkpoints
        obj = torch.load(path, map_location="cpu", weights_only=False)

    def convert(v):
        if isinstance(v, torch.Tensor):
            return _upcast(v.numpy())
        return np.asarray(v)

    if isinstance(obj, torch.Tensor):
        return {"embeddings": _upcast(obj.numpy())}
    if isinstance(obj, dict):
        return {k: convert(v) for k, v in obj.items()}
    raise ValueError(f"{path}: unsupported .pt payload type {type(obj)!r}")


def _read(p: Path) -> Dict[str, np.ndarray]:
    if p.suffix == ".pt":
        return load_pt(p)
    with np.load(p) as z:
        return {k: _upcast(z[k]) for k in z.files}


class EmbeddingStore:
    def __init__(self, root: str | Path, dataset_name: str):
        self.root = Path(root)
        self.dataset_name = dataset_name

    def version_dir(self, version_key: str) -> Path:
        """Write-side directory of a version (SHS: the plain set-id folder)."""
        if self.dataset_name == "shs":
            return self.root / version_key.split("-", 1)[0] / version_key
        return self.root / version_key

    def path(self, version_key: str, filename: str) -> Optional[Path]:
        """The existing file for (version, filename), probing the ``.pt`` of
        the same stem when the ``.npz`` is absent."""
        p = find_embedding_path(self.dataset_name, self.root, version_key, filename)
        if p is None and filename.endswith(".npz"):
            p = find_embedding_path(
                self.dataset_name, self.root, version_key, filename[: -len(".npz")] + ".pt"
            )
        return p

    def save(self, version_key: str, filename: str, **arrays: np.ndarray) -> Path:
        """Write arrays as an fp16 ``.npz`` (atomic rename)."""
        d = self.version_dir(version_key)
        d.mkdir(parents=True, exist_ok=True)
        out = d / filename
        tmp = out.with_suffix(".tmp.npz")
        np.savez(tmp, **{
            k: (v.astype(np.float16) if np.issubdtype(v.dtype, np.floating) else v)
            for k, v in arrays.items()
        })
        tmp.replace(out)
        return out

    def load(self, version_key: str, filename: str) -> Optional[Dict[str, np.ndarray]]:
        """Arrays with floats upcast to fp32; None when missing or corrupt."""
        p = self.path(version_key, filename)
        if p is None:
            return None
        with contextlib.suppress(*_CORRUPT):
            return _read(p)
        return None

    def exists(self, version_key: str, filename: str) -> bool:
        return self.path(version_key, filename) is not None

    def verify(self, md: Metadata, filename: str,
               out_dir: Optional[str | Path] = None) -> Dict[str, List[str]]:
        """Missing embedding files per split; with ``out_dir`` also writes
        the ``missing_embeddings_{stem}.txt`` work list."""
        missing = {
            split: [v for versions in md.splits[split].values() for v in versions
                    if not self.exists(v, filename)]
            for split in SPLITS
        }
        if out_dir is not None:
            out_dir = Path(out_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            stem = filename.rsplit(".", 1)[0]
            all_missing = [v for split in SPLITS for v in missing[split]]
            (out_dir / f"missing_embeddings_{stem}.txt").write_text(
                "\n".join(all_missing) + ("\n" if all_missing else "")
            )
        return missing
