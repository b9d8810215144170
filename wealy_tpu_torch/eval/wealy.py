"""WEALY-specific evaluation, the counterpart of ``wealy_tpu.eval.wealy``:
song-level retrieval over per-song chunk sets, and over fused multimodal
embeddings.

- WEALY test mode gives per-song dicts with ALL (n_chunks, 512) chunk
  embeddings -> pairwise chunk distances + the redux (K4 for ``bpwr``);
- fusion models give one z per song -> cosine ranking.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.eval.retrieval import rank_metrics, song_distance_matrix
from wealy_tpu_torch.ops.distance import pairwise_distance_matrix


def wealy_song_sets(songs: Sequence[dict]):
    """Per-song dicts (``wealy_test_mode_items``) -> padded chunk sets:
    (sets (S, max_chunks, C), mask (S, max_chunks) True=valid, labels (S,),
    version_ids (S,))."""
    chunks = [np.atleast_2d(np.asarray(s["wealy_all_chunks"], np.float32)) for s in songs]
    max_chunks = max(c.shape[0] for c in chunks)
    sets = np.zeros((len(chunks), max_chunks, chunks[0].shape[-1]), np.float32)
    mask = np.zeros((len(chunks), max_chunks), bool)
    for i, c in enumerate(chunks):
        sets[i, : c.shape[0]] = c
        mask[i, : c.shape[0]] = True
    labels = np.array([s["clique_id"] for s in songs])
    ids = np.array([s["version_id"] for s in songs])
    return sets, mask, labels, ids


def evaluate_wealy_songs(songs: Sequence[dict], mode: str = "cos", redux: str = "bpwr",
                         topk=(10,), device=None) -> Dict[str, float]:
    """All-pairs MAP/MR1 over WEALY chunk sets (chunk-set scoring through
    the redux), on ``device`` (the card unless the caller asks for the
    CPU)."""
    sets, mask, labels, ids = wealy_song_sets(songs)
    d = song_distance_matrix(sets, mask, sets, mask, mode=mode, redux=redux, device=device)
    return rank_metrics(d, labels, labels, query_idx=ids, cand_idx=ids, topk=topk)


@torch.no_grad()
def evaluate_song_embeddings(z: np.ndarray, labels: np.ndarray,
                             version_ids: Optional[np.ndarray] = None, mode: str = "cos",
                             topk=(10,), device=None) -> Dict[str, float]:
    """All-pairs MAP/MR1 over one embedding per song (fusion-model eval)."""
    zt = torch.as_tensor(np.asarray(z, np.float32), device=resolve_device(device))
    d = pairwise_distance_matrix(zt, zt, mode=mode).cpu().numpy()
    return rank_metrics(d, labels, labels, query_idx=version_ids, cand_idx=version_ids,
                        topk=topk)
