"""Collates with static output shapes, copied from
``wealy_tpu.data.chunking``.

- :func:`collate_fixed_length` (train / val): one window of ``chunk_size``
  frames per version, random (train) or the first (val), zero-padded with a
  mask; the SBERT (one step) and CLEWS (fixed shape) overrides; dtype
  preserving (an fp16 store collates to fp16). :meth:`Batch.flatten_versions`
  gives the (B * n, ...) layout the losses consume.
- :func:`collate_overlapping` (test): overlapping windows per song (stride =
  chunk_size - int(chunk_size * overlap)), the chunk count padded to a
  multiple of ``chunk_bucket`` with a chunk-valid mask; ``chunk_info`` rows
  (batch_idx, version_idx, chunk_idx) regroup chunks per song.
- :func:`collate_avg_pool`: time collapsed to one vector per version.
- :func:`collate_full_songs` (``data.fullsongs``): whole sequences padded
  to a length bucket.
- :func:`select_wealy_chunk`: the WEALY chunk axis (train random, val
  first, test all).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

Item = Tuple[int, List[Tuple[int, Optional[np.ndarray]]]]
# one item = (clique_label, [(version_id, embedding (T, C) or None), ...])


def _embed_dim(items: Sequence[Item]) -> int:
    for _, versions in items:
        for _, emb in versions:
            if emb is not None:
                return np.asarray(emb).shape[-1]
    raise ValueError("all embeddings in batch are None")


def select_wealy_chunk(
    wealy: np.ndarray, mode: str, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """(n_chunks, 512) -> train 'random' one chunk (512,), val
    'deterministic' the first chunk, test 'all' every chunk."""
    wealy = np.asarray(wealy)
    if wealy.ndim == 1:
        wealy = wealy[None]
    if mode == "random":
        if wealy.shape[0] == 1:
            return wealy[0]
        if rng is None:
            raise ValueError("mode='random' needs an rng")
        return wealy[int(rng.integers(0, wealy.shape[0]))]
    if mode == "deterministic":
        return wealy[0]
    if mode == "all":
        return wealy
    raise ValueError(f"unknown WEALY chunking mode: {mode!r}")


def chunk_embedding(
    emb: Optional[np.ndarray],
    chunk_size: int,
    mode: str,
    embed_dim: int,
    rng: Optional[np.random.Generator] = None,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (T, C) embedding -> ((chunk_size, C) in ``dtype``, (chunk_size,)
    True=valid): mode 'random' a random full window when T > chunk_size,
    'first' the prefix; shorter sequences zero-padded; None all-invalid."""
    out = np.zeros((chunk_size, embed_dim), dtype)
    mask = np.zeros((chunk_size,), bool)
    if emb is None:
        return out, mask
    emb = np.asarray(emb)
    T = emb.shape[0]
    if T <= chunk_size:
        out[:T] = emb
        mask[:T] = True
    elif mode == "random":
        if rng is None:
            raise ValueError("mode='random' needs an rng")
        start = int(rng.integers(0, T - chunk_size + 1))
        out[:] = emb[start : start + chunk_size]
        mask[:] = True
    else:  # first
        out[:] = emb[:chunk_size]
        mask[:] = True
    return out, mask


@dataclasses.dataclass
class Batch:
    """Fixed-shape batch: (B,) cliques, (B, n) version ids, embeddings and
    masks with a leading (B, n)."""

    clique_ids: np.ndarray
    version_ids: np.ndarray
    embeddings: np.ndarray
    masks: np.ndarray

    def flatten_versions(self):
        """-> (z_label (B*n,), z_idx (B*n,), emb (B*n, ...), mask (B*n, ...)),
        the layout the losses consume (labels repeat per version)."""
        B, n = self.version_ids.shape
        labels = np.repeat(self.clique_ids, n)
        idx = self.version_ids.reshape(-1)
        emb = self.embeddings.reshape(B * n, *self.embeddings.shape[2:])
        mask = self.masks.reshape(B * n, *self.masks.shape[2:])
        return labels, idx, emb, mask


def _fixed_length_for(items: Sequence[Item], chunk_size: int,
                      embedding_type: str) -> Tuple[int, int, np.dtype]:
    """(length, embed_dim, alloc dtype) with the SBERT / CLEWS fixed-shape
    overrides; the dtype is the first embedding's float dtype (f32 for
    non-float sources)."""
    first = next((np.asarray(emb) for _, versions in items for _, emb in versions
                  if emb is not None), None)
    if first is None:
        raise ValueError("all embeddings in batch are None")
    embed_dim = first.shape[-1]
    dt = first.dtype if np.issubdtype(first.dtype, np.floating) else np.dtype(np.float32)
    if first.shape[0] == 1:  # sbert-like
        return 1, embed_dim, dt
    if embedding_type == "clews":  # fixed (16, 2048)
        return first.shape[0], embed_dim, dt
    return chunk_size, embed_dim, dt


def collate_fixed_length(
    items: Sequence[Item],
    chunk_size: int = 1000,
    use_random_chunks: bool = False,
    embedding_type: str = "whisper",
    rng: Optional[np.random.Generator] = None,
) -> Batch:
    """Train / val collate: one fixed window per version."""
    B = len(items)
    n = len(items[0][1])
    L, C, edt = _fixed_length_for(items, chunk_size, embedding_type)
    mode = "random" if use_random_chunks else "first"
    clique_ids = np.empty((B,), np.int64)
    version_ids = np.zeros((B, n), np.int64)
    embeddings = np.zeros((B, n, L, C), edt)
    masks = np.zeros((B, n, L), bool)
    for i, (label, versions) in enumerate(items):
        clique_ids[i] = label
        for j, (vid, emb) in enumerate(versions):
            version_ids[i, j] = vid
            if emb is not None and np.asarray(emb).shape[0] == 1:
                embeddings[i, j, 0] = np.asarray(emb)[0]
                masks[i, j, 0] = True
            elif embedding_type == "clews" and emb is not None:
                embeddings[i, j, :] = np.asarray(emb)
                masks[i, j, :] = True
            else:
                embeddings[i, j], masks[i, j] = chunk_embedding(emb, L, mode, C, rng, dtype=edt)
    return Batch(clique_ids, version_ids, embeddings, masks)


def collate_full_songs(
    items: Sequence[Item], length_bucket: int = 256, max_length: Optional[int] = None
) -> Batch:
    """``fullsongs`` collate: no chunking; sequences padded to the batch max
    rounded up to a multiple of ``length_bucket``, optionally capped at
    ``max_length``."""
    B, n, C = len(items), len(items[0][1]), _embed_dim(items)
    longest = max([1] + [np.asarray(emb).shape[0] for _, versions in items
                         for _, emb in versions if emb is not None])
    L = -(-longest // length_bucket) * length_bucket
    if max_length is not None:
        L = min(L, max_length)
    clique_ids = np.empty((B,), np.int64)
    version_ids = np.zeros((B, n), np.int64)
    embeddings = np.zeros((B, n, L, C), np.float32)
    masks = np.zeros((B, n, L), bool)
    for i, (label, versions) in enumerate(items):
        clique_ids[i] = label
        for j, (vid, emb) in enumerate(versions):
            version_ids[i, j] = vid
            if emb is None:
                continue
            e = np.asarray(emb, np.float32)[:L]
            embeddings[i, j, : e.shape[0]] = e
            masks[i, j, : e.shape[0]] = True
    return Batch(clique_ids, version_ids, embeddings, masks)


def collate_avg_pool(items: Sequence[Item]) -> Batch:
    """Avg-pooling collate: one mean vector per version; masks (B, n) True =
    embedding present."""
    B, n, C = len(items), len(items[0][1]), _embed_dim(items)
    clique_ids = np.empty((B,), np.int64)
    version_ids = np.zeros((B, n), np.int64)
    embeddings = np.zeros((B, n, C), np.float32)
    masks = np.zeros((B, n), bool)
    for i, (label, versions) in enumerate(items):
        clique_ids[i] = label
        for j, (vid, emb) in enumerate(versions):
            version_ids[i, j] = vid
            if emb is None:
                continue
            emb = np.asarray(emb, np.float32)
            embeddings[i, j] = emb[0] if emb.shape[0] == 1 else emb.mean(axis=0)
            masks[i, j] = True
    return Batch(clique_ids, version_ids, embeddings, masks)


@dataclasses.dataclass
class ChunkedBatch:
    """Test-time overlapping-chunk batch; rows beyond ``n_chunks`` are bucket
    padding (chunk_valid False)."""

    clique_ids: np.ndarray  # (N,)
    version_ids: np.ndarray  # (N,)
    embeddings: np.ndarray  # (N, L, C)
    masks: np.ndarray  # (N, L)
    chunk_info: np.ndarray  # (N, 3) int
    chunk_valid: np.ndarray  # (N,) bool
    n_chunks: int


def collate_overlapping(
    items: Sequence[Item],
    chunk_size: int = 1000,
    overlap: float = 0.9,
    embedding_type: str = "whisper",
    chunk_bucket: int = 64,
) -> ChunkedBatch:
    """Test collate: overlapping windows per song, the chunk count padded to
    a multiple of ``chunk_bucket``."""
    stride = max(1, chunk_size - int(chunk_size * overlap))
    rows = []  # (clique, version, chunk (L, C) or None, mask (L,) or None, i, j, k)
    fixed = None
    for i, (label, versions) in enumerate(items):
        for j, (vid, emb) in enumerate(versions):
            if emb is None:
                rows.append((label, vid, None, None, i, j, 0))
                continue
            emb = np.asarray(emb, np.float32)
            T = emb.shape[0]
            if T == 1 or embedding_type == "clews":
                # fixed-shape embeddings: a single chunk, as-is
                fixed = T if fixed is None else fixed
                rows.append((label, vid, emb, np.ones(T, bool), i, j, 0))
            elif T <= chunk_size:
                chunk = np.zeros((chunk_size, emb.shape[-1]), np.float32)
                mask = np.zeros((chunk_size,), bool)
                chunk[:T] = emb
                mask[:T] = True
                rows.append((label, vid, chunk, mask, i, j, 0))
            else:
                for k, start in enumerate(range(0, T - chunk_size + 1, stride)):
                    rows.append((label, vid, emb[start : start + chunk_size],
                                 np.ones(chunk_size, bool), i, j, k))

    L = fixed if fixed is not None else chunk_size
    C = next((r[2].shape[-1] for r in rows if r[2] is not None), None)
    if C is None:
        raise ValueError("all embeddings in batch are None")
    n_real = len(rows)
    N = -(-n_real // chunk_bucket) * chunk_bucket
    clique_ids = np.zeros((N,), np.int64)
    version_ids = np.zeros((N,), np.int64)
    embeddings = np.zeros((N, L, C), np.float32)
    masks = np.zeros((N, L), bool)
    chunk_info = np.full((N, 3), -1, np.int64)
    chunk_valid = np.zeros((N,), bool)
    for idx, (label, vid, chunk, mask, i, j, k) in enumerate(rows):
        clique_ids[idx] = label
        version_ids[idx] = vid
        if chunk is not None:
            embeddings[idx, : chunk.shape[0]] = chunk
            masks[idx, : chunk.shape[0]] = mask
        chunk_info[idx] = (i, j, k)
        chunk_valid[idx] = True
    return ChunkedBatch(
        clique_ids, version_ids, embeddings, masks, chunk_info, chunk_valid, n_real
    )
