"""Read side of the packed memory-mapped embedding store, the counterpart of
``wealy_tpu.data.packed_store.PackedStore`` (packs are written by the JAX
package's ``pack`` command; the port reads them).

Layout under ``root``:
  packed_{dataset}_{kind}.bin   C-contiguous (total_rows, dim) bytes
  packed_{dataset}_{kind}.json  {"dim", "dtype", "bin_bytes", "fingerprint",
                                 "dataset", "versions": {key: [row, shape...]}}
(``packed_{kind}.*`` for packs written before dataset namespacing). A pack
whose binary does not match its manifest's size and head/tail fingerprint
is ignored, never read misaligned.
"""

from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _fingerprint(path: Path) -> str:
    """sha1 over the size and the first and last 4 KiB of the file."""
    size = path.stat().st_size
    h = hashlib.sha1(str(size).encode())
    with open(path, "rb") as f:
        h.update(f.read(4096))
        if size > 4096:
            f.seek(max(0, size - 4096))
            h.update(f.read(4096))
    return h.hexdigest()


class PackedStore:
    """Reader for the pack of one embedding kind."""

    def __init__(self, root: str | Path, kind: str, dataset_name: Optional[str] = None):
        self.root = Path(root)
        self.kind = kind.removesuffix(".npz").removesuffix(".pt")
        stem = f"packed_{dataset_name}_{self.kind}" if dataset_name else f"packed_{self.kind}"
        self.bin_path = self.root / f"{stem}.bin"
        self.manifest_path = self.root / f"{stem}.json"
        if dataset_name and not self.manifest_path.exists():
            legacy_bin = self.root / f"packed_{self.kind}.bin"
            legacy_man = self.root / f"packed_{self.kind}.json"
            if legacy_man.exists() and legacy_bin.exists():
                self.bin_path, self.manifest_path = legacy_bin, legacy_man
        self._mmap: Optional[np.memmap] = None
        self._index: Dict[str, tuple] = {}  # key -> (flat_row_offset, shape)
        self._dim = 0
        self._dtype = np.dtype(np.float16)
        if not (self.manifest_path.exists() and self.bin_path.exists()):
            return
        meta = json.loads(self.manifest_path.read_text())
        ok = (
            "bin_bytes" in meta
            and self.bin_path.stat().st_size == meta["bin_bytes"]
            and (not dataset_name or meta.get("dataset") in (None, dataset_name))
            and ("fingerprint" not in meta or _fingerprint(self.bin_path) == meta["fingerprint"])
        )
        if not ok:
            logger.warning(
                "packed store %s does not match its manifest or dataset — ignoring it",
                self.bin_path,
            )
            return
        self._dim = int(meta["dim"])
        self._dtype = np.dtype(meta.get("dtype", "float16"))
        self._index = {
            k: (int(v[0]), tuple(int(d) for d in v[1:])) for k, v in meta["versions"].items()
        }

    @property
    def available(self) -> bool:
        return bool(self._index)

    def __contains__(self, version_key: str) -> bool:
        return version_key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def keys(self):
        return self._index.keys()

    def _rows(self) -> np.memmap:
        if self._mmap is None:
            total = sum(int(np.prod(s[:-1], dtype=np.int64)) for _, s in self._index.values())
            self._mmap = np.memmap(
                self.bin_path, dtype=self._dtype, mode="r", shape=(total, self._dim)
            )
        return self._mmap

    def newer_files_exist(self, store, filename: str, versions, sample: int = 8) -> bool:
        """True if any sampled per-version file is newer than the pack binary
        (re-extracted without repacking)."""
        if not self.bin_path.exists():
            return True
        bin_mtime = self.bin_path.stat().st_mtime
        versions = list(versions)
        step = max(1, len(versions) // max(1, sample))
        for v in versions[::step][:sample]:
            p = store.path(v, filename) if store else None
            if p is not None and p.exists() and p.stat().st_mtime > bin_mtime:
                return True
        return False

    def load(self, version_key: str, dtype=np.float32) -> Optional[np.ndarray]:
        """The array in its original shape (upcast to ``dtype``), or None
        if the version is not packed."""
        ent = self._index.get(version_key)
        if ent is None:
            return None
        off, shape = ent
        n = int(np.prod(shape[:-1], dtype=np.int64))
        flat = self._rows()[off : off + n]
        if np.dtype(dtype) == self._dtype:
            return flat.reshape(shape)
        return np.asarray(flat, dtype=dtype).reshape(shape)
