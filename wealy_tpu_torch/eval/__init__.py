"""Retrieval evaluation of the port: MAP / MR1 / P@k over chunk-set song
distances, the counterpart of ``wealy_tpu.eval`` (its names load on first
access)."""

from wealy_tpu_torch._lazy import lazy_getattr

_LAZY = {
    "wealy_tpu_torch.eval.retrieval": (
        "average_precision", "rank_metrics", "regroup_chunks", "song_distance_matrix",
        "evaluate_retrieval",
    ),
}
__getattr__ = lazy_getattr(__name__, _LAZY)

__all__ = [
    "average_precision", "rank_metrics", "regroup_chunks", "song_distance_matrix",
    "evaluate_retrieval",
]
