"""Retrieval metrics and chunk -> song scoring, the counterpart of
``wealy_tpu.eval.retrieval``.

- :func:`regroup_chunks`: flat chunk batch -> (n_songs, max_chunks, C) + mask
- :func:`song_distance_matrix`: chunk-set distances reduced to song pairs
  with any redux mode; ``bpwr`` without a generator goes through K4
  (``ops/bpwr_redux.py``), every other mode through plain torch ops
- :func:`rank_metrics`: MAP / MR1 / P@k, self-match excluded by version idx
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.ops.bpwr_redux import bpwr_block_redux
from wealy_tpu_torch.ops.distance import pairwise_distance_matrix
from wealy_tpu_torch.ops.redux import distance_tensor_redux


def average_precision(rel_sorted: np.ndarray) -> float:
    """AP of one query given relevance flags in rank order (self excluded)."""
    rel_sorted = np.asarray(rel_sorted, dtype=bool)
    n_rel = rel_sorted.sum()
    if n_rel == 0:
        return 0.0
    ranks = np.flatnonzero(rel_sorted) + 1
    return float((np.arange(1, n_rel + 1) / ranks).mean())


def rank_metrics(
    dist: np.ndarray,
    query_labels: np.ndarray,
    cand_labels: np.ndarray,
    query_idx: Optional[np.ndarray] = None,
    cand_idx: Optional[np.ndarray] = None,
    topk: Tuple[int, ...] = (10,),
) -> Dict[str, float]:
    """MAP / MR1 / P@k from a (Q, N) distance matrix (smaller = closer).
    Self-matches (same idx) are excluded; queries without a relevant
    candidate are skipped."""
    dist = np.asarray(dist)
    Q, N = dist.shape
    query_labels = np.asarray(query_labels)
    cand_labels = np.asarray(cand_labels)
    query_idx = np.arange(Q) if query_idx is None else np.asarray(query_idx)
    cand_idx = np.arange(N) if cand_idx is None else np.asarray(cand_idx)

    aps, first_ranks, pk = [], [], {k: [] for k in topk}
    for q in range(Q):
        keep = cand_idx != query_idx[q]
        order = np.argsort(dist[q][keep], kind="stable")
        rel = (cand_labels[keep] == query_labels[q])[order]
        if not rel.any():
            continue
        aps.append(average_precision(rel))
        first_ranks.append(int(np.flatnonzero(rel)[0]) + 1)
        for k in topk:
            pk[k].append(float(rel[:k].sum()) / k)
    out = {
        "MAP": float(np.mean(aps)) if aps else 0.0,
        "MR1": float(np.mean(first_ranks)) if first_ranks else 0.0,
        "n_queries": len(aps),
    }
    for k in topk:
        out[f"P@{k}"] = float(np.mean(pk[k])) if pk[k] else 0.0
    return out


@torch.no_grad()
def slabbed_apply(apply_fn, *arrays: np.ndarray, slab_size: int = 256,
                  device=None) -> np.ndarray:
    """``apply_fn(*slabs) -> z_slab`` over flat batches sharing a leading
    dim, in fixed-size slabs (the last one zero-padded) on ``device``, so
    that host and device memory hold one slab's activations at a time."""
    device = resolve_device(device)
    n = arrays[0].shape[0]
    slab_size = min(slab_size, max(n, 1))
    outs = []
    for s in range(0, n, slab_size):
        slabs = [a[s : s + slab_size] for a in arrays]
        pad = slab_size - slabs[0].shape[0]
        if pad:
            slabs = [np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)]) for a in slabs]
        z = apply_fn(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in slabs))
        z = z.cpu().numpy()
        outs.append(z[: slab_size - pad] if pad else z)
    if not outs:
        return np.zeros((0, 0), np.float32)
    return np.concatenate(outs, axis=0)


def regroup_chunks(
    chunk_embeddings: np.ndarray,
    chunk_info: np.ndarray,
    chunk_valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flat per-chunk embeddings -> per-song chunk sets, songs keyed by
    (batch_idx, version_idx) in first-appearance order.

    Returns (song_sets (S, max_chunks, C), set_mask (S, max_chunks)
    True=valid, song_batch_idx (S,), song_version_idx (S,)).
    """
    chunk_embeddings = np.asarray(chunk_embeddings)
    chunk_info = np.asarray(chunk_info)
    if chunk_valid is not None:
        keep = np.asarray(chunk_valid, bool)
        chunk_embeddings = chunk_embeddings[keep]
        chunk_info = chunk_info[keep]
    songs: dict[tuple, list[int]] = {}
    for row, (b, v, _k) in enumerate(chunk_info):
        songs.setdefault((int(b), int(v)), []).append(row)
    keys = list(songs.keys())
    max_chunks = max(len(rows) for rows in songs.values())
    sets = np.zeros((len(keys), max_chunks, chunk_embeddings.shape[-1]), chunk_embeddings.dtype)
    mask = np.zeros((len(keys), max_chunks), bool)
    for s, key in enumerate(keys):
        rows = songs[key]
        sets[s, : len(rows)] = chunk_embeddings[rows]
        mask[s, : len(rows)] = True
    return sets, mask, np.array([k[0] for k in keys]), np.array([k[1] for k in keys])


def song_distance_matrix_torch(query_sets, query_mask, cand_sets, cand_mask, mode: str = "cos",
                               redux: str = "bpwr", generator: Optional[torch.Generator] = None):
    """(Q, s1, C) x (N, s2, C) chunk-set tensors (masks True=valid, all on
    one device) -> (Q, N) song distances, on that device."""
    Q, s1, C = query_sets.shape
    N, s2, _ = cand_sets.shape
    d = pairwise_distance_matrix(query_sets.reshape(Q * s1, C), cand_sets.reshape(N * s2, C),
                                 mode=mode)
    d = d.reshape(Q, s1, N, s2).permute(0, 2, 1, 3)  # (Q, N, s1, s2), a view
    if redux.split("-")[0] == "bpwr" and generator is None:
        return bpwr_block_redux(d, query_mask, cand_mask, redux)
    excl = (~query_mask)[:, None, :, None] | (~cand_mask)[None, :, None, :]
    return distance_tensor_redux(d, redux, mask=excl.expand(d.shape), generator=generator)


@torch.no_grad()
def song_distance_matrix(
    query_sets: np.ndarray,
    query_mask: np.ndarray,
    cand_sets: np.ndarray,
    cand_mask: np.ndarray,
    mode: str = "cos",
    redux: str = "bpwr",
    generator: Optional[torch.Generator] = None,
    device=None,
) -> np.ndarray:
    """(Q, s1, C) x (N, s2, C) chunk sets -> (Q, N) song distances: one
    chunk-pair distance product, then the redux under the mask of invalid
    (padding) chunks, on ``device`` (default: the card when there is one)."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return song_distance_matrix_torch(
        t(query_sets), t(query_mask).bool(), t(cand_sets), t(cand_mask).bool(),
        mode=mode, redux=redux, generator=generator,
    ).cpu().numpy()


def evaluate_retrieval(
    song_sets: np.ndarray,
    set_mask: np.ndarray,
    labels: np.ndarray,
    version_ids: Optional[np.ndarray] = None,
    mode: str = "cos",
    redux: str = "bpwr",
    topk: Tuple[int, ...] = (10,),
    device=None,
) -> Dict[str, float]:
    """All-pairs retrieval within one corpus: every song queries all others.
    rank_metrics plus the (S, S) distance matrix under ``_dist``."""
    d = song_distance_matrix(song_sets, set_mask, song_sets, set_mask, mode=mode, redux=redux,
                             device=device)
    metrics = rank_metrics(d, labels, labels, query_idx=version_ids, cand_idx=version_ids,
                           topk=topk)
    metrics["_dist"] = d
    return metrics
