"""Dataset metadata, stores, sampling and collates of the port: host-side
numpy code copied from ``wealy_tpu.data`` (CSV through the stdlib ``csv``
module, no pandas). The names ``wealy_tpu.data`` exports load on first
access."""

from wealy_tpu_torch._lazy import lazy_getattr

_LAZY = {
    "wealy_tpu_torch.data.metadata": (
        "Metadata", "load_metadata", "load_shs", "load_lyric_covers", "load_discogs_vi",
    ),
    "wealy_tpu_torch.data.ids": (
        "deterministic_song_id", "assign_deterministic_ids", "global_clique_id_mapping",
    ),
    "wealy_tpu_torch.data.filters": (
        "remove_versions_without_audio", "remove_single_version_cliques",
        "remove_overlapping_cliques",
    ),
    "wealy_tpu_torch.data.transcription": ("TranscriptionValidator", "TranscriptionCache"),
}
__getattr__ = lazy_getattr(__name__, _LAZY)

__all__ = [
    "Metadata", "load_metadata", "load_shs", "load_lyric_covers", "load_discogs_vi",
    "deterministic_song_id", "assign_deterministic_ids", "global_clique_id_mapping",
    "remove_versions_without_audio", "remove_single_version_cliques", "remove_overlapping_cliques",
    "TranscriptionValidator", "TranscriptionCache",
]
