"""Dataset metadata: readers for shs / lyric-covers / discogs-vi, a copy of
``wealy_tpu.data.metadata`` that reads CSV with the stdlib ``csv`` module in
place of pandas and gives the same ``Metadata``.

Column types follow pandas' inference for the cases these files hold: a
column whose cells all read as integers is ``int``, as numbers ``float``,
as ``True``/``False`` ``bool``, anything else ``str``; an empty cell is
NaN. ``astype(str)`` of those values is ``str()`` of them.

Version-key / filename conventions (reference metadata_loaders.py:195-213):
  shs          key "{set_id}-{ver_id}"    file "{set_id}-{ver_id}.mp3"
  lyric-covers key str(id)                file "{id}_audio.mp3"
  discogs-vi   key base_filename          file "{base_filename}.mp3"
"""

from __future__ import annotations

import csv
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

SPLITS = ("train", "val", "test")

DATASET_NAMES = ("shs", "lyric-covers", "discogs-vi")

_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|[+-]?(inf|nan)", re.IGNORECASE)
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}


@dataclasses.dataclass
class Metadata:
    """info: version_key -> field dict (id, clique, clique_idx, version_idx,
    filename, version_key + per-dataset extras). splits: split -> clique_id ->
    [version_keys]."""

    dataset_name: str
    info: Dict[str, dict]
    splits: Dict[str, Dict[str, List[str]]]

    def versions_in_split(self, split: str) -> List[str]:
        return [v for versions in self.splits[split].values() for v in versions]

    def n_versions(self) -> int:
        return len(self.info)

    def prune_to_splits(self) -> None:
        """Drop info entries whose version no longer appears in any split."""
        keep = set()
        for split in SPLITS:
            for versions in self.splits[split].values():
                keep.update(versions)
        self.info = {k: v for k, v in self.info.items() if k in keep}

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"dataset_name": self.dataset_name, "info": self.info, "splits": self.splits}
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(path)

    @classmethod
    def load(cls, path: str | Path) -> "Metadata":
        payload = json.loads(Path(path).read_text())
        return cls(
            dataset_name=payload["dataset_name"], info=payload["info"], splits=payload["splits"]
        )


def _typed_columns(rows: List[List[str]], names: Sequence[str]) -> List[dict]:
    """Cells -> typed values, one type per column (pandas' inference)."""
    cols = []
    for c in range(len(names)):
        cells = [row[c] if c < len(row) else "" for row in rows]
        full = [v for v in cells if v != ""]
        if full and all(_INT.fullmatch(v) for v in full) and len(full) == len(cells):
            cols.append([int(v) for v in cells])
        elif full and all(_INT.fullmatch(v) or _FLOAT.fullmatch(v) for v in full):
            cols.append([float(v) if v != "" else float("nan") for v in cells])
        elif full and all(v in _BOOLS for v in full) and len(full) == len(cells):
            cols.append([_BOOLS[v] for v in cells])
        else:
            cols.append([v if v != "" else float("nan") for v in cells])
    return [dict(zip(names, values)) for values in zip(*cols)] if cols else []


def _raw_csv(path: str | Path, sep: str = ",", header: bool = True):
    """(header or None, rows of cell strings)."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f, delimiter=sep)]
    return (rows[0], rows[1:]) if header else (None, rows)


def read_csv(path: str | Path, names: Optional[Sequence[str]] = None, sep: str = ",",
             usecols: Optional[Sequence[int]] = None) -> List[dict]:
    """Rows of a CSV file as dicts of typed values. With ``names`` the file
    has no header row; ``usecols`` keeps those column positions."""
    header, rows = _raw_csv(path, sep, header=names is None)
    if usecols is not None:
        rows = [[row[i] if i < len(row) else "" for i in usecols] for row in rows]
    return _typed_columns(rows, list(names if names is not None else header))


def _build(rows: List[dict], dataset_name: str, extras: Dict[str, str]) -> Metadata:
    """info/splits from rows with version_key, filename, clique_id and split
    (+ extra columns), as ``wealy_tpu.data.metadata._build``."""
    for r in rows:
        r["clique_id"] = str(r["clique_id"])
    # sorted-unique integer indices (id_mapper.py:15-45 semantics)
    c2i = {c: i for i, c in enumerate(sorted({r["clique_id"] for r in rows}))}
    v2i = {v: i for i, v in enumerate(sorted({r["version_key"] for r in rows}))}

    info: Dict[str, dict] = {}
    splits: Dict[str, Dict[str, List[str]]] = {s: {} for s in SPLITS}
    for r in rows:
        entry = {
            "id": v2i[r["version_key"]],
            "clique": r["clique_id"],
            "clique_idx": c2i[r["clique_id"]],
            "version_idx": v2i[r["version_key"]],
            "filename": r["filename"],
            "version_key": r["version_key"],
        }
        for field, col in extras.items():
            entry[field] = r[col]
        info[r["version_key"]] = entry
        if r["split"] in SPLITS:
            splits[r["split"]].setdefault(r["clique_id"], []).append(r["version_key"])
    return Metadata(dataset_name=dataset_name, info=info, splits=splits)


def load_shs(data_csv: str | Path, splits_dir: str | Path) -> Metadata:
    """SHS100K: main CSV (set_id, ver_id, ...) inner-joined with the
    tab-separated SHS100K-{TRAIN,VAL,TEST} split files (no header)."""
    main = read_csv(data_csv)
    split_rows: Dict[tuple, List[str]] = {}
    for split, fname in (("train", "SHS100K-TRAIN"), ("val", "SHS100K-VAL"),
                         ("test", "SHS100K-TEST")):
        for r in read_csv(Path(splits_dir) / fname, names=["set_id", "ver_id"], sep="\t",
                          usecols=[0, 1]):
            split_rows.setdefault((r["set_id"], r["ver_id"]), []).append(split)
    rows = []
    for r in main:  # inner merge, in the order of the main file's rows
        for split in split_rows.get((r["set_id"], r["ver_id"]), []):
            key = f"{r['set_id']}-{r['ver_id']}"
            rows.append({**r, "split": split, "clique_id": r["set_id"], "version_key": key,
                         "filename": key + ".mp3"})
    return _build(rows, "shs", {"set_id": "set_id", "ver_id": "ver_id"})


def load_lyric_covers(data_dir: str | Path) -> Metadata:
    """LyricCovers: {train,val,test}_no_dup.csv with header
    original_id,id,is_cover,song_text_type,label; clique=label, version=id."""
    cells = []
    for split in SPLITS:  # typed after concatenation, as pandas' concat does
        header, part = _raw_csv(Path(data_dir) / f"{split}_no_dup.csv")
        cells.extend(row + [split] for row in part)
    rows = _typed_columns(cells, header + ["split"])
    for r in rows:
        r["clique_id"] = r["label"]
        r["version_key"] = str(r["id"])
        r["filename"] = r["version_key"] + "_audio.mp3"
        r["original_id"] = str(r["original_id"])
        r["song_text_type"] = str(r["song_text_type"])
        r["version_id"] = r["version_key"]
    return _build(rows, "lyric-covers", {
        "original_id": "original_id",
        "is_cover": "is_cover",
        "song_text_type": "song_text_type",
        "version_id": "version_id",
    })


def load_discogs_vi(data_dir: str | Path) -> Metadata:
    """Discogs-VI-YT: headerless id-to-file-mapping.csv with columns
    [split, clique_id, version_id, youtube_id, base_filename]."""
    rows = read_csv(
        Path(data_dir) / "id-to-file-mapping.csv",
        names=["split", "clique_id", "version_id", "youtube_id", "base_filename"],
    )
    for r in rows:
        for col in ("version_id", "youtube_id", "base_filename"):
            r[col] = str(r[col])
        r["version_key"] = r["base_filename"]
        r["filename"] = r["base_filename"] + ".mp3"
    return _build(rows, "discogs-vi", {
        "base_filename": "base_filename",
        "youtube_id": "youtube_id",
        "version_id": "version_id",
    })


def load_metadata(
    dataset_name: str,
    *,
    shs_data: Optional[str] = None,
    shs_splits: Optional[str] = None,
    lyric_covers_data: Optional[str] = None,
    discogs_vi_data: Optional[str] = None,
    meta_cache: Optional[str] = None,
) -> Metadata:
    """The saved metadata file first (conf.path.meta), else the dataset's CSVs."""
    if meta_cache and Path(meta_cache).exists():
        return Metadata.load(meta_cache)
    if dataset_name == "shs":
        md = load_shs(shs_data, shs_splits)
    elif dataset_name == "lyric-covers":
        md = load_lyric_covers(lyric_covers_data)
    elif dataset_name == "discogs-vi":
        md = load_discogs_vi(discogs_vi_data)
    else:
        raise ValueError(f"unknown dataset {dataset_name!r}; expected {DATASET_NAMES}")
    if meta_cache:
        md.save(meta_cache)
    return md
