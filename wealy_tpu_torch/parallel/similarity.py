"""Sharded all-pairs similarity and corpus-scale exact ranking without the
(Q, N) matrix: the counterpart of ``wealy_tpu.parallel.similarity``.

Eager torch takes the place of ``jit`` and ``lax.scan``: Python loops over
query slabs and corpus blocks, each block's (q_block, block) score slab made
on the device, consumed and dropped. On a mesh (``parallel/mesh.py``) the
query rows shard over the ``data`` axis: each rank scores its contiguous
slice of the queries against the whole corpus on its card, and the rows are
gathered back, so every rank returns the whole result
(:func:`sharded_pairwise_distance`, :func:`sharded_topk`,
:func:`streaming_relevant_ranks` with ``mesh``).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.eval.retrieval import song_distance_matrix_torch
from wealy_tpu_torch.ops.distance import pairwise_distance_matrix
from wealy_tpu_torch.parallel.mesh import Mesh, all_gather, local_chunk

logger = logging.getLogger(__name__)

# bound on the (q_block, slots, block) comparison tensor of one count step
_COUNT_ELEMENTS = 1 << 26


def _query_shard(mesh: Mesh, x) -> Tuple[torch.Tensor, int]:
    """This data rank's contiguous slice of the rows of ``x`` (padded with
    zero rows to a multiple of the data axis), on the mesh's device, and
    the real row count."""
    x = torch.as_tensor(np.asarray(x))
    q = x.shape[0]
    pad = (-q) % mesh.size("data")
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    return local_chunk(mesh, x, "data", 0).to(mesh.device), q


def sharded_pairwise_distance(x, y, mesh: Mesh, mode: str = "cossim",
                              block_size: Optional[int] = None) -> torch.Tensor:
    """(Q, C) x (N, C) -> (Q, N) distance/similarity, query rows sharded
    over ``data`` and gathered; candidates whole on every rank. With
    ``block_size``, candidate columns go in blocks (per-rank memory (Q/d,
    block) per product instead of (Q/d, N))."""
    xs, q = _query_shard(mesh, x)
    y = torch.as_tensor(np.asarray(y)).to(mesh.device)
    if block_size is None:
        d = pairwise_distance_matrix(xs, y, mode=mode)
    else:
        d = torch.cat([pairwise_distance_matrix(xs, y[b : b + block_size], mode=mode)
                       for b in range(0, y.shape[0], block_size)], dim=1)
    return all_gather(mesh, d, "data")[:q]


def _top(scores: torch.Tensor, k: int):
    """The k largest per row, equal scores in column order (the first
    wins, as ``lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def sharded_topk(x, y, mesh: Mesh, k: int, mode: str = "cossim", largest: Optional[bool] = None,
                 block_size: Optional[int] = None):
    """Top-k candidate scores and indices per query, (Q, k) each, query
    rows sharded over ``data``; similarity modes take the largest,
    distance modes the smallest. ``block_size``: candidate columns in
    blocks with a running top-k merge, per-rank memory (Q/d, block) instead
    of (Q/d, N). Ties keep the earlier column, blocked or not: the running
    carry (earlier columns) goes before each new block and the merge sort
    is stable."""
    if largest is None:
        largest = mode.endswith("sim")
    xs, q = _query_shard(mesh, x)
    y = torch.as_tensor(np.asarray(y)).to(mesh.device)
    N = y.shape[0]
    k = min(k, N)
    sign = 1.0 if largest else -1.0
    if block_size is None or block_size >= N:
        vals, idx = _top(sign * pairwise_distance_matrix(xs, y, mode=mode).float(), k)
    else:
        vals = torch.full((xs.shape[0], 0), float("-inf"), device=xs.device)
        idx = torch.zeros((xs.shape[0], 0), dtype=torch.int64, device=xs.device)
        for b in range(0, N, block_size):
            s = sign * pairwise_distance_matrix(xs, y[b : b + block_size], mode=mode).float()
            bv, bi = _top(s, min(k, s.shape[1]))
            mv, sel = _top(torch.cat([vals, bv], dim=1), k)
            idx = torch.take_along_dim(torch.cat([idx, bi + b], dim=1), sel, dim=1)
            vals = mv
    vals = all_gather(mesh, sign * vals, "data")[:q]
    return vals, all_gather(mesh, idx, "data")[:q]


def relevant_columns(
    query_labels,
    corpus_labels,
    query_idx=None,
    corpus_idx=None,
    max_relevant: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per query: the corpus positions with the same label, self (same idx)
    excluded, in ascending corpus order. Returns (rel_cols (Q, R) int64 with
    -1 padding, n_rel (Q,) int32). R is the largest relevant set unless
    ``max_relevant`` caps it, which is logged, never silent."""
    query_labels = np.asarray(query_labels)
    corpus_labels = np.asarray(corpus_labels)
    Q = query_labels.shape[0]
    N = corpus_labels.shape[0]
    query_idx = np.arange(Q) if query_idx is None else np.asarray(query_idx)
    corpus_idx = np.arange(N) if corpus_idx is None else np.asarray(corpus_idx)

    order = np.argsort(corpus_labels, kind="stable")
    sorted_labels = corpus_labels[order]
    lo = np.searchsorted(sorted_labels, query_labels, side="left")
    hi = np.searchsorted(sorted_labels, query_labels, side="right")
    counts = hi - lo  # same-label candidates including self
    r_full = max(int(counts.max()) if Q else 0, 1)
    slot = np.arange(r_full)
    pos = lo[:, None] + slot[None, :]
    valid = slot[None, :] < counts[:, None]
    cols = order[np.minimum(pos, N - 1)]
    valid &= ~(valid & (corpus_idx[cols] == query_idx[:, None]))
    # compact: a stable sort moves invalid slots to the row end, keeps order
    perm = np.argsort(~valid, axis=1, kind="stable")
    cols = np.take_along_axis(np.where(valid, cols, -1), perm, axis=1)
    n_rel = valid.sum(axis=1).astype(np.int32)
    r_max = max(int(n_rel.max()) if Q else 0, 1)
    cols = cols[:, :r_max]
    if max_relevant is not None and r_max > max_relevant:
        logger.warning(
            "relevant_columns: max_relevant=%d truncates %d/%d queries (largest relevant "
            "set: %d) — MAP will undercount those cliques",
            max_relevant, int((n_rel > max_relevant).sum()), Q, r_max,
        )
        cols = cols[:, :max_relevant]
        n_rel = np.minimum(n_rel, max_relevant).astype(np.int32)
    return cols.astype(np.int64), n_rel


def _padded(a: np.ndarray, rows: int, fill=0) -> np.ndarray:
    out = np.full((rows, *a.shape[1:]), fill, a.dtype)
    out[: a.shape[0]] = a
    return out


@torch.no_grad()
def streaming_relevant_ranks(
    queries,
    corpus,
    query_labels,
    corpus_labels,
    mode: str = "cossim",
    block_size: int = 4096,
    query_block: int = 8192,
    query_idx=None,
    corpus_idx=None,
    max_relevant: Optional[int] = None,
    query_mask=None,
    corpus_mask=None,
    redux: str = "bpwr",
    resident="auto",
    resident_budget_mb: float = 512.0,
    device=None,
    mesh: Optional[Mesh] = None,
):
    """Exact 1-based ranks of every relevant candidate per query, without
    the (Q, N) matrix.

    Queries go in ``query_block`` slabs; per slab the corpus is walked twice
    in ``block_size`` blocks: pass 1 gathers each relevant pair's score,
    pass 2 counts the candidates ranked ahead of it. Both passes compute a
    block with the same function on the same inputs, so their scores are
    bit-equal and ties compare exactly: rank = 1 + #(strictly better) +
    #(equal score at an earlier corpus position), self excluded, which is
    :func:`wealy_tpu_torch.eval.retrieval.rank_metrics`'s stable sort.

    ``resident``: when the padded corpus fits ``resident_budget_mb``
    (``"auto"``), or with ``True``, it is copied to the device once and
    both passes index its blocks there; ``False`` copies each block from the
    host as it is used. The blocks and their math are the same either way,
    so the ranks are bit-equal.

    Chunk sets: 3-D ``queries`` / ``corpus`` (Q, s, C) with (Q, s)
    True=valid ``query_mask`` / ``corpus_mask`` score each block by chunk
    distances reduced with ``redux`` (``bpwr`` through K4). Use a distance
    mode ("cos").

    ``mesh``: the queries shard over its ``data`` axis (contiguous slices,
    the corpus whole on every rank's card) and the ranks are gathered; each
    query's ranks are those of the single-device run, and every rank
    returns all of them.

    Returns (ranks (Q, R) int32, 0 = empty slot, n_rel (Q,)) for
    :func:`map_from_ranks`.
    """
    if mesh is not None and mesh.active("data"):
        return _mesh_relevant_ranks(
            mesh, queries, corpus, query_labels, corpus_labels, query_idx, corpus_idx,
            query_mask, dict(mode=mode, block_size=block_size, query_block=query_block,
                             max_relevant=max_relevant, corpus_mask=corpus_mask, redux=redux,
                             resident=resident, resident_budget_mb=resident_budget_mb))
    device = resolve_device(device) if mesh is None else mesh.device
    corpus = np.asarray(corpus)
    queries = np.asarray(queries)
    sets = queries.ndim == 3
    if sets:
        if corpus.ndim != 3 or query_mask is None or corpus_mask is None:
            raise ValueError("chunk-set queries need a chunk-set corpus and both masks")
        if mode.endswith("sim"):
            raise ValueError("chunk-set scoring reduces distances; use a distance mode ('cos')")
        query_mask = np.asarray(query_mask, bool)
        corpus_mask = np.asarray(corpus_mask, bool)

        def block_dist(q, qm, y, ym):
            # all-padding rows and columns reduce over empty masks; n_valid and
            # the relevant-column bookkeeping keep them out of the ranks
            return song_distance_matrix_torch(q, qm, y, ym, mode=mode, redux=redux)
    else:
        def block_dist(q, qm, y, ym):
            return pairwise_distance_matrix(q, y, mode=mode)

    Q, N = queries.shape[0], corpus.shape[0]
    query_idx = np.arange(Q) if query_idx is None else np.asarray(query_idx)
    corpus_idx = np.arange(N) if corpus_idx is None else np.asarray(corpus_idx)
    query_idx = query_idx.astype(np.int64)
    corpus_idx = corpus_idx.astype(np.int64)
    sim_mode = mode.endswith("sim")  # larger = better

    rel_cols, n_rel = relevant_columns(
        query_labels, corpus_labels, query_idx, corpus_idx, max_relevant
    )
    R = rel_cols.shape[1]
    b = min(block_size, max(N, 1))
    qb = min(query_block, max(Q, 1))
    n_blocks = -(-N // b)
    if not sets:
        query_mask = np.ones((Q, 1), bool)
        corpus_mask = np.ones((N, 1), bool)

    corpus_bytes = n_blocks * b * int(np.prod(corpus.shape[1:], dtype=np.int64)) \
        * corpus.dtype.itemsize
    use_resident = resident is True or (
        resident == "auto" and corpus_bytes <= resident_budget_mb * 1e6
    )

    def host_block(blk: int):
        s, e = blk * b, min(blk * b + b, N)
        return (_padded(corpus[s:e], b), _padded(corpus_mask[s:e], b, False),
                _padded(corpus_idx[s:e], b, -1))

    if use_resident:
        stacked = [np.stack(parts) for parts in zip(*(host_block(k) for k in range(n_blocks)))]
        y_all, ym_all, cidx_all = (torch.from_numpy(a).to(device) for a in stacked)

        def device_block(blk: int):
            return y_all[blk], ym_all[blk], cidx_all[blk]
    else:
        def device_block(blk: int):
            return tuple(torch.from_numpy(a).to(device) for a in host_block(blk))

    arange_b = torch.arange(b, device=device)
    slots = max(1, min(R, _COUNT_ELEMENTS // max(1, qb * b)))
    ranks_out = np.zeros((Q, R), np.int32)
    for s0 in range(0, Q, qb):
        e0 = min(s0 + qb, Q)
        cols_slab = _padded(rel_cols[s0:e0], qb, -1)
        q = torch.from_numpy(_padded(queries[s0:e0], qb)).to(device)
        qm = torch.from_numpy(_padded(query_mask[s0:e0], qb, False)).to(device)
        cols = torch.from_numpy(cols_slab).to(device)
        qidx = torch.from_numpy(_padded(query_idx[s0:e0], qb, -1)).to(device)

        rel_scores = torch.zeros((qb, R), dtype=torch.float32, device=device)
        for blk in range(n_blocks):
            y, ym, _ = device_block(blk)
            d = block_dist(q, qm, y, ym)  # (qb, b)
            start, n_valid = blk * b, min(b, N - blk * b)
            local = cols - start
            in_blk = (local >= 0) & (local < n_valid) & (cols >= 0)
            g = torch.take_along_dim(d, local.clamp(0, b - 1), dim=1)
            rel_scores = torch.where(in_blk, g, rel_scores)

        better = torch.zeros((qb, R), dtype=torch.int64, device=device)
        for blk in range(n_blocks):
            y, ym, cidx = device_block(blk)
            d = block_dist(q, qm, y, ym)[:, None, :]  # (qb, 1, b)
            start, n_valid = blk * b, min(b, N - blk * b)
            colpos = (start + arange_b)[None, None, :]
            # (qb, 1, b): padded columns and self excluded
            col_ok = ((arange_b < n_valid)[None, :] & (cidx[None, :] != qidx[:, None]))[:, None]
            for r0 in range(0, R, slots):
                ref = rel_scores[:, r0 : r0 + slots, None]
                rc = cols[:, r0 : r0 + slots, None]
                ahead = d > ref if sim_mode else d < ref
                tie = (d == ref) & (colpos < rc)
                better[:, r0 : r0 + slots] += ((ahead | tie) & col_ok).sum(dim=-1)

        slab_ranks = better.cpu().numpy()[: e0 - s0]
        ranks_out[s0:e0] = np.where(cols_slab[: e0 - s0] >= 0, slab_ranks + 1, 0)
    return ranks_out, n_rel


def _mesh_relevant_ranks(mesh: Mesh, queries, corpus, query_labels, corpus_labels, query_idx,
                         corpus_idx, query_mask, kw: dict):
    """:func:`streaming_relevant_ranks` of this data rank's slice of the
    queries, every slice's ranks gathered (each padded to the widest
    relevant set)."""
    queries = np.asarray(queries)
    Q = queries.shape[0]
    query_idx = np.arange(Q) if query_idx is None else np.asarray(query_idx)
    _, n_rel = relevant_columns(query_labels, corpus_labels, query_idx, corpus_idx,
                                kw["max_relevant"])
    R = max(int(n_rel.max()) if Q else 0, 1)
    per = -(-Q // mesh.size("data"))
    lo = min(mesh.index("data") * per, Q)
    hi = min(lo + per, Q)
    ranks = np.zeros((per, R), np.int32)
    if hi > lo:
        part, _ = streaming_relevant_ranks(
            queries[lo:hi], corpus, np.asarray(query_labels)[lo:hi], corpus_labels,
            query_idx=query_idx[lo:hi], corpus_idx=corpus_idx,
            query_mask=None if query_mask is None else np.asarray(query_mask)[lo:hi],
            device=mesh.device, **kw)
        ranks[: hi - lo, : part.shape[1]] = part
    got = all_gather(mesh, torch.from_numpy(ranks).to(mesh.device), "data")
    return got.cpu().numpy()[:Q], n_rel


def map_from_ranks(ranks, n_rel, topk: Tuple[int, ...] = ()):
    """MAP / MR1 (and P@k) from per-query relevant ranks (1-based stable-sort
    positions, 0 = empty slot); equal to ``rank_metrics`` on the same
    scores. Queries without relevant candidates are skipped."""
    ranks = np.asarray(ranks)
    n_rel = np.asarray(n_rel)
    Q, R = ranks.shape
    valid = np.arange(R)[None, :] < n_rel[:, None]
    has_rel = n_rel > 0
    r = np.sort(np.where(valid, ranks.astype(np.float64), np.inf), axis=1)
    i = np.arange(1, R + 1, dtype=np.float64)[None, :]
    aps = np.where(valid, i / r, 0.0).sum(axis=1) / np.maximum(n_rel, 1)
    mr1 = np.where(has_rel, r[:, 0], 0)
    out = {
        "MAP": float(aps[has_rel].mean()) if has_rel.any() else 0.0,
        "MR1": float(mr1[has_rel].mean()) if has_rel.any() else 0.0,
        "n_queries": int(has_rel.sum()),
    }
    for k in topk:
        hits = ((ranks <= k) & (ranks > 0) & valid).sum(axis=1)
        out[f"P@{k}"] = float((hits[has_rel] / k).mean()) if has_rel.any() else 0.0
    return out
