"""Collate factory, ``conf.model.name``-dispatched batching: a copy of
``wealy_tpu.data.collate_factory``.

  single-modal (whisper / clews embedding_type)   -> Batch (chunking.py)
  wealy-clews family (wealy-clews, multimodal-cross-attention,
    multimodal-concatenation, multimodal-cross-attention-residual)
    -> dict: clique_ids (B,), version_ids (B,n), wealy (B,n,zdim),
       full_clews (B,n,L,2048), avg_clews (B,n,2048), clews_mask (B,n,L)
       [True = INVALID, ops convention]
  whisper-clews family (whisper-clews, multimodal-two-stream)
    -> dict: + whisper_seq (B,n,chunk,1280), whisper_mask (B,n,chunk)

``apply_masks_with_padding`` compacts each CLEWS sequence to its valid
positions and re-pads to the batch max. WEALY chunk modes: train random /
val first / test all (:func:`wealy_test_mode_items`, per-song dicts).
Multimodal batches carry both ``full_clews`` and ``avg_clews``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from wealy_tpu_torch.data.chunking import (
    chunk_embedding,
    collate_avg_pool,
    collate_fixed_length,
    collate_full_songs,
    collate_overlapping,
    select_wealy_chunk,
)
from wealy_tpu_torch.train.config import Config

WEALY_CLEWS_MODELS = (
    "wealy-clews",
    "multimodal-cross-attention",
    "multimodal-concatenation",
    "multimodal-cross-attention-residual",
)
WHISPER_CLEWS_MODELS = ("whisper-clews", "multimodal-two-stream")

MMItem = Tuple[int, List[Tuple[int, dict]]]  # (label, [(version_id, mmdict)])


def _compact_clews(full: np.ndarray, mask: np.ndarray, out_len: int):
    """Keep valid (mask=False) positions, re-pad to ``out_len``; returns
    (padded (out_len, C), new_mask (out_len,) True=padding)."""
    kept = np.asarray(full)[~np.asarray(mask, bool)]
    out = np.zeros((out_len, full.shape[-1]), np.float32)
    new_mask = np.ones((out_len,), bool)
    n = min(len(kept), out_len)
    out[:n] = kept[:n]
    new_mask[:n] = False
    return out, new_mask


def _collate_clews_block(items: Sequence[MMItem], apply_masks_with_padding: bool):
    """The CLEWS tensors of both multimodal families."""
    B, n = len(items), len(items[0][1])
    first = items[0][1][0][1]
    Lfull, C = first["full_clews"].shape
    if apply_masks_with_padding:
        L = max(1, max(int((~np.asarray(mm["clews_mask"], bool)).sum())
                       for _, versions in items for _, mm in versions))
    else:
        L = Lfull
    full_clews = np.zeros((B, n, L, C), np.float32)
    avg_clews = np.zeros((B, n, first["avg_clews"].shape[-1]), np.float32)
    clews_mask = np.ones((B, n, L), bool)
    for i, (_, versions) in enumerate(items):
        for j, (_, mm) in enumerate(versions):
            if apply_masks_with_padding:
                full_clews[i, j], clews_mask[i, j] = _compact_clews(
                    mm["full_clews"], mm["clews_mask"], L)
            else:
                full_clews[i, j] = mm["full_clews"]
                clews_mask[i, j] = np.asarray(mm["clews_mask"], bool)
            avg_clews[i, j] = mm["avg_clews"]
    return full_clews, avg_clews, clews_mask


def _ids_block(items: Sequence[MMItem]):
    clique_ids = np.array([label for label, _ in items], np.int64)
    version_ids = np.array([[vid for vid, _ in versions] for _, versions in items], np.int64)
    return clique_ids, version_ids


def collate_wealy_clews(
    items: Sequence[MMItem],
    wealy_mode: str = "random",
    apply_masks_with_padding: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """WEALY+CLEWS family batch (the reference's five items per version)."""
    clique_ids, version_ids = _ids_block(items)
    B, n = version_ids.shape
    zdim = items[0][1][0][1]["wealy"]["embeddings"].shape[-1]
    wealy = np.zeros((B, n, zdim), np.float32)
    for i, (_, versions) in enumerate(items):
        for j, (_, mm) in enumerate(versions):
            w = select_wealy_chunk(mm["wealy"]["embeddings"], wealy_mode, rng)
            wealy[i, j] = np.ravel(w)[:zdim]
    full_clews, avg_clews, clews_mask = _collate_clews_block(items, apply_masks_with_padding)
    return {
        "clique_ids": clique_ids,
        "version_ids": version_ids,
        "wealy": wealy,
        "full_clews": full_clews,
        "avg_clews": avg_clews,
        "clews_mask": clews_mask,
    }


def wealy_test_mode_items(items: Sequence[MMItem]) -> List[dict]:
    """Test mode: per-song dicts carrying ALL WEALY chunks."""
    return [
        {
            "clique_id": label,
            "version_id": vid,
            "wealy_all_chunks": select_wealy_chunk(mm["wealy"]["embeddings"], "all"),
            "full_clews": mm["full_clews"],
            "avg_clews": mm["avg_clews"],
            "clews_mask": mm["clews_mask"],
            "batch_idx": i,
            "version_idx": j,
        }
        for i, (label, versions) in enumerate(items)
        for j, (vid, mm) in enumerate(versions)
    ]


def whisper_clews_test_mode_items(
    items: Sequence[MMItem],
    chunk_size: int = 1000,
    overlap: float = 0.9,
) -> List[dict]:
    """Whisper+CLEWS test mode: per-song dicts carrying ALL overlapping
    whisper-sequence windows plus the song's CLEWS context.

    Windows: stride = chunk_size - int(chunk_size * overlap), windows fully
    inside the sequence only (the tail is dropped); a sequence shorter than
    one window gives one zero-padded chunk with a validity mask.
    """
    stride = max(1, chunk_size - int(chunk_size * overlap))
    out = []
    for i, (label, versions) in enumerate(items):
        for j, (vid, mm) in enumerate(versions):
            seq = np.asarray(mm["whisper_seq"], np.float32)
            T, C = seq.shape
            if T <= chunk_size:
                chunks = np.zeros((1, chunk_size, C), np.float32)
                valid = np.zeros((1, chunk_size), bool)
                chunks[0, :T] = seq
                valid[0, :T] = True
            else:
                starts = list(range(0, T - chunk_size + 1, stride))
                chunks = np.stack([seq[s : s + chunk_size] for s in starts])
                valid = np.ones((len(starts), chunk_size), bool)
            out.append({
                "clique_id": label,
                "version_id": vid,
                "whisper_chunks": chunks,
                "whisper_chunk_valid": valid,
                "full_clews": mm["full_clews"],
                "avg_clews": mm["avg_clews"],
                "clews_mask": mm["clews_mask"],
                "batch_idx": i,
                "version_idx": j,
            })
    return out


def collate_whisper_clews(
    items: Sequence[MMItem],
    chunk_size: int = 1000,
    use_random_chunks: bool = False,
    apply_masks_with_padding: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Whisper+CLEWS family batch (the reference's six items per version)."""
    clique_ids, version_ids = _ids_block(items)
    B, n = version_ids.shape
    C = items[0][1][0][1]["whisper_seq"].shape[-1]
    whisper_seq = np.zeros((B, n, chunk_size, C), np.float32)
    whisper_mask = np.ones((B, n, chunk_size), bool)  # True = invalid
    mode = "random" if use_random_chunks else "first"
    for i, (_, versions) in enumerate(items):
        for j, (_, mm) in enumerate(versions):
            emb, valid = chunk_embedding(mm["whisper_seq"], chunk_size, mode, C, rng)
            whisper_seq[i, j] = emb
            whisper_mask[i, j] = ~valid
    full_clews, avg_clews, clews_mask = _collate_clews_block(items, apply_masks_with_padding)
    return {
        "clique_ids": clique_ids,
        "version_ids": version_ids,
        "whisper_seq": whisper_seq,
        "whisper_mask": whisper_mask,
        "full_clews": full_clews,
        "avg_clews": avg_clews,
        "clews_mask": clews_mask,
    }


def create_collate_fn(
    config: Config,
    deterministic: bool = False,
    use_overlapping_chunks: bool = False,
    overlap_percentage: float = 0.9,
    use_avg_pooling: Optional[bool] = None,
    apply_masks_with_padding: Optional[bool] = None,
    rng: Optional[np.random.Generator] = None,
) -> Callable:
    """The collate of ``config.model.name``."""
    name = config.model.name
    rng = rng or np.random.default_rng(0)
    if use_avg_pooling is None:
        use_avg_pooling = config.data.use_avg_pooling
    if apply_masks_with_padding is None:
        apply_masks_with_padding = config.data.apply_masks_with_padding
    chunk_size = config.data.chunk_size

    if name in WEALY_CLEWS_MODELS:
        if use_overlapping_chunks:
            return wealy_test_mode_items
        wealy_mode = "deterministic" if deterministic else "random"
        return lambda items: collate_wealy_clews(
            items, wealy_mode=wealy_mode, apply_masks_with_padding=apply_masks_with_padding,
            rng=rng)
    if name in WHISPER_CLEWS_MODELS:
        if use_overlapping_chunks:
            return lambda items: whisper_clews_test_mode_items(
                items, chunk_size=chunk_size, overlap=overlap_percentage)
        use_random = not deterministic and config.data.use_random_chunks
        return lambda items: collate_whisper_clews(
            items, chunk_size=chunk_size, use_random_chunks=use_random,
            apply_masks_with_padding=apply_masks_with_padding, rng=rng)

    # single-modal
    embedding_type = "clews" if config.data.embedding_type == "clews" else "whisper"
    if use_avg_pooling:
        return collate_avg_pool
    if config.data.fullsongs and not use_overlapping_chunks:
        return collate_full_songs
    if use_overlapping_chunks:
        return lambda items: collate_overlapping(
            items, chunk_size=chunk_size, overlap=overlap_percentage,
            embedding_type=embedding_type)
    use_random = (not deterministic) and config.data.use_random_chunks
    return lambda items: collate_fixed_length(
        items, chunk_size=chunk_size, use_random_chunks=use_random,
        embedding_type=embedding_type, rng=rng)
