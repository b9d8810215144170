"""The packed memory-mapped embedding store, the counterpart of
``wealy_tpu.data.packed_store``: one fp16 binary per embedding kind (shared
by every split) and a JSON manifest. Either package reads the other's packs.

Layout under ``root``:
  packed_{dataset}_{kind}.bin   C-contiguous (total_rows, dim) bytes
  packed_{dataset}_{kind}.json  {"dim", "dtype", "bin_bytes", "fingerprint",
                                 "dataset", "versions": {key: [row, shape...]}}
(``packed_{kind}.*`` for packs written before dataset namespacing). A pack
whose binary does not match its manifest's size and head/tail fingerprint
is ignored, never read misaligned.

:class:`PackWriter` writes a pack one version at a time (the sink of
``extract --pack-direct``); :meth:`PackedStore.pack` and
:func:`pack_from_store` (the ``pack`` command) are built on it. ``close()``
writes a temporary binary, fsyncs it and renames it into place, then does
the same for the manifest, so a reader sees the old pack until then and a
crash between the two renames reads as "no pack".
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _stem(kind: str, dataset_name: Optional[str]) -> str:
    return f"packed_{dataset_name}_{kind}" if dataset_name else f"packed_{kind}"


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
        self.dataset_name = dataset_name
        stem = _stem(self.kind, dataset_name)
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
        if the version is not packed. In the pack's own dtype it is a view
        of the memory map (no copy); a converting load reads its rows from
        the file instead, because every page of the map that a stream
        touches stays resident in the process while the map lives, so a
        pass over a split would hold the whole pack (once per reader)."""
        ent = self._index.get(version_key)
        if ent is None:
            return None
        off, shape = ent
        n = int(np.prod(shape[:-1], dtype=np.int64))
        if np.dtype(dtype) == self._dtype:
            return self._rows()[off : off + n].reshape(shape)
        rows = np.empty((n, self._dim), self._dtype)
        with open(self.bin_path, "rb") as f:
            f.seek(off * self._dim * self._dtype.itemsize)
            got = f.readinto(rows)
        if got != rows.nbytes:
            raise OSError(f"{self.bin_path}: short read of {version_key!r} ({got} bytes)")
        return rows.astype(dtype).reshape(shape)

    @classmethod
    def pack(cls, root: str | Path, kind: str, arrays: Iterable[tuple], dtype=np.float16,
             dataset_name: Optional[str] = None) -> "PackedStore":
        """Write a pack from ``(version_key, array)`` pairs (any rank >= 1;
        a 1-D array is stored as one row and loads back 1-D), one version
        at a time, and return its reader."""
        with PackWriter(root, kind, dtype=dtype, dataset_name=dataset_name) as writer:
            for key, arr in arrays:
                writer.add(key, arr)
        return writer.close()


class PackWriter:
    """Incremental pack writer: ``add(key, arr)`` appends one version's rows
    to a temporary binary, ``close()`` makes the pack visible (fsync, then
    rename the binary, then the manifest). Until ``close()`` readers see
    the old pack, or none; ``abort()`` drops the temporary file, and so
    does leaving a ``with PackWriter(...)`` block by an exception (which
    goes on)."""

    def __init__(self, root: str | Path, kind: str, dtype=np.float16,
                 dataset_name: Optional[str] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.kind = kind.removesuffix(".npz").removesuffix(".pt")
        self.dtype = np.dtype(dtype)
        self.dataset_name = dataset_name
        self._stem = _stem(self.kind, dataset_name)
        self._bin_tmp = self.root / f".{self._stem}.bin.tmp"
        self._f = open(self._bin_tmp, "wb")
        self._index: Dict[str, list] = {}
        self._dim: Optional[int] = None
        self._offset = 0

    def __enter__(self) -> "PackWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.abort()
        return False

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def add(self, key: str, arr) -> None:
        """Append one version; a key already added is kept as first written
        (keys shared between split files pack once)."""
        if key in self._index:
            return
        orig = np.asarray(arr)
        a = np.ascontiguousarray(np.atleast_2d(orig), dtype=self.dtype)
        if self._dim is None:
            self._dim = a.shape[-1]
        elif a.shape[-1] != self._dim:
            raise ValueError(
                f"inconsistent embedding dim for {key!r}: {a.shape[-1]} != {self._dim}"
            )
        self._f.write(a.tobytes())
        # the manifest keeps the original shape; offsets count 2-D rows
        self._index[key] = [self._offset, *orig.shape]
        self._offset += int(np.prod(a.shape[:-1], dtype=np.int64))

    def seed_from(self, old: PackedStore, versions) -> int:
        """Carry already-packed versions forward from ``old`` (the resume of
        a direct-to-pack extraction), in the old pack's dtype; returns how
        many were carried."""
        n = 0
        for v in versions:
            if v in old and v not in self._index:
                self.add(v, old.load(v, dtype=old._dtype))
                n += 1
        return n

    def abort(self) -> None:
        self._f.close()
        self._bin_tmp.unlink(missing_ok=True)

    def close(self) -> PackedStore:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        bin_final = self.root / f"{self._stem}.bin"
        os.replace(self._bin_tmp, bin_final)
        manifest = {
            "dim": int(self._dim or 0),
            "dtype": self.dtype.name,
            "bin_bytes": bin_final.stat().st_size,
            "fingerprint": _fingerprint(bin_final),
            "dataset": self.dataset_name,
            "versions": self._index,
        }
        man_tmp = self.root / f".{self._stem}.json.tmp"
        with open(man_tmp, "w") as f:
            f.write(json.dumps(manifest))
            f.flush()
            os.fsync(f.fileno())
        os.replace(man_tmp, self.root / f"{self._stem}.json")
        return PackedStore(self.root, self.kind, dataset_name=self.dataset_name)


def pack_from_store(store, versions, filename: str, root: str | Path,
                    dataset_name: Optional[str] = None) -> PackedStore:
    """Pack each version's main array (``embeddings``, else its first) from
    a per-version :class:`EmbeddingStore`; versions without a file are
    left out (they stay on the per-version path and in the verifier's
    missing-work lists), duplicates pack once."""

    def rows():
        for v in dict.fromkeys(versions):
            data = store.load(v, filename)
            if data is None:
                continue
            arr = data.get("embeddings")
            if arr is None:
                arr = next(iter(data.values()))
            yield v, arr

    return PackedStore.pack(root, filename, rows(), dataset_name=dataset_name)
