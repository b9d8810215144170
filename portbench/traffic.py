"""The general traffic generator: what a workload file's ``traffic`` block
asks for, made from the seed.

Audio traffic (``"kind": "audio_split"``): a pool of WAV files (16-bit PCM
mono at the block's sample rate), whose lengths are fixed quantiles of a
log-normal (the same set of sizes for every seed) and whose every 30 s
section, one chunk, has notes, noise and a level of its own, and a project in the
lyric-covers layout whose split lists ``n_versions`` version ids in cliques
of ``clique_size``. Each id is a symlink to a pool file: the seed shuffles
the pool once for each pass over it, so every seed sends the same mix in
another order. The pool depends on the block alone, so it is written once
into the checkout (``portbench/.cache/``) and read by every later run; the
project (symlinks and CSVs) is made under ``TMPDIR`` in every run.

The project writers follow ``write_audio_project`` / ``write_wav`` /
``write_split_csvs`` in the repository's ``chip_smoke.py``, copied here so
that the yardstick does not move with the program.
"""

from __future__ import annotations

import csv
import hashlib
import json
import math
import os
import shutil
import statistics
import wave
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parent / ".cache"


def pool_lengths(block: dict) -> list:
    """Seconds of each pool file: the (i + 1/2) / n quantiles of a
    log-normal with the block's median and sigma, clipped and rounded to
    whole seconds."""
    n, dist = block["pool_files"], statistics.NormalDist()
    out = []
    for i in range(n):
        s = block["median_s"] * math.exp(block["sigma"] * dist.inv_cdf((i + 0.5) / n))
        out.append(int(round(min(max(s, block["min_s"]), block["max_s"]))))
    return out


# a section of a pool file is one 30 s chunk of the port's (and the
# reference's) chunking: each has a character of its own
SECTION_S = 30


def _section(rng, n: int, sr: int) -> np.ndarray:
    """``n`` samples of one section: notes of a few harmonics over a drawn
    register, each note with its own pitch and length (0.2-1.2 s), shaped
    noise, and a level, all drawn from ``rng``; so no two sections, nor two
    stretches of one, carry the same signal."""
    level = float(np.exp(rng.uniform(np.log(0.04), np.log(0.5))))
    base = float(np.exp(rng.uniform(np.log(70.0), np.log(900.0))))
    harmonics = int(rng.integers(1, 6))
    noise = float(rng.uniform(0.02, 0.4))
    out = np.zeros(n, np.float32)
    at = 0
    while at < n:
        m = min(n - at, int(sr * rng.uniform(0.2, 1.2)))
        t = np.arange(m, dtype=np.float32) / sr
        f0 = base * 2.0 ** (int(rng.integers(0, 25)) / 12.0)
        env = np.minimum(1.0, t / 0.02) * np.exp(-t * rng.uniform(0.5, 6.0))
        note = np.zeros(m, np.float32)
        for k in range(1, harmonics + 1):
            if k * f0 < sr / 2:
                note += np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k
        note += noise * rng.standard_normal(m, dtype=np.float32) * np.sqrt(harmonics)
        out[at:at + m] = level * env * note / np.sqrt(harmonics)
        at += m
    return out


def _song_wav(path: Path, seconds: int, sr: int, index: int) -> None:
    """16-bit mono of one pool file: a section of its own (:func:`_section`)
    for each 30 s, drawn from the file's index."""
    rng = np.random.default_rng(1000 + index)
    n = seconds * sr
    x = np.concatenate([_section(rng, min(SECTION_S * sr, n - a), sr)
                        for a in range(0, n, SECTION_S * sr)])
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def audio_pool(block: dict) -> list:
    """Paths of the pool's WAV files, written into the checkout's cache on
    the first call and read from it after."""
    keys = ("pool_files", "median_s", "sigma", "min_s", "max_s", "sample_rate")
    spec = json.dumps(dict({k: block[k] for k in keys}, synth="sections"), sort_keys=True)
    root = CACHE / f"audio-{hashlib.sha256(spec.encode()).hexdigest()[:16]}"
    lengths = pool_lengths(block)
    paths = [root / f"pool_{i:03d}.wav" for i in range(len(lengths))]
    if not (root / "complete").exists():
        part = root.with_name(root.name + ".part")
        shutil.rmtree(part, ignore_errors=True)
        part.mkdir(parents=True)
        for i, seconds in enumerate(lengths):
            _song_wav(part / paths[i].name, seconds, block["sample_rate"], i)
        (part / "complete").write_text(spec)
        shutil.rmtree(root, ignore_errors=True)
        os.replace(part, root)
        os.sync()  # the pool's writeback ends here, inside set-up
    return paths


def pool_order(n_pool: int, n_versions: int, seed: int) -> np.ndarray:
    """Pool index of each version: one seeded shuffle of the pool for each
    pass over it."""
    rng = np.random.default_rng(seed)
    passes = -(-n_versions // n_pool)
    return np.concatenate([rng.permutation(n_pool) for _ in range(passes)])[:n_versions]


def write_split_csvs(lc: Path, splits: dict) -> None:
    """``{split}_no_dup.csv`` of the lyric-covers layout from ``{split:
    [(version id, clique label)]}``: a clique's first version is the
    original, the others its covers."""
    header = ["original_id", "id", "is_cover", "song_text_type", "label"]
    for split, rows in splits.items():
        first: dict = {}
        with open(lc / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            for vid, label in rows:
                w.writerow([first.setdefault(label, vid), vid, first[label] != vid, "o", label])


def audio_project(root: Path, block: dict, seed: int, whisper_size: str) -> dict:
    """The lyric-covers project of an audio block under ``root``: {"config":
    path of its config file, "split": "test", "versions": {version id: pool
    file}}."""
    pool = audio_pool(block)
    order = pool_order(len(pool), block["n_versions"], seed)
    lc, audio = root / "lc", root / "data" / "LyricCovers" / "audio"
    lc.mkdir(parents=True)
    rows, versions = [], {}
    for j, p in enumerate(order):
        vid = 100000 + j
        d = audio / str(vid)
        d.mkdir(parents=True)
        os.symlink(pool[p], d / f"{vid}_audio.mp3")
        rows.append((vid, f"clique{j // block['clique_size']}"))
        versions[str(vid)] = str(pool[p])
    write_split_csvs(lc, {"test": rows, "train": [], "val": []})
    conf = {
        "path": {"lyric_covers_data": str(lc), "hidden_states": str(root / "hs"),
                 "data": str(root / "data")},
        "data": {"dataset_name": "lyric-covers"},
        "model": {"name": "whisper", "whisper_size": whisper_size},
    }
    config = root / "config.json"
    config.write_text(json.dumps(conf))
    return {"config": str(config), "split": "test", "versions": versions}
