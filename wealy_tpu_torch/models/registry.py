"""Model registry keyed by ``conf.model.name``: the counterpart of
``wealy_tpu.models.registry``, all seven names.

``build_model`` returns (module, call signature):

- ``"single"``: ``(emb, mask) -> z`` (``whisper``);
- ``"wealy"``: ``(wealy_vec, clews_seq, clews_mask) -> z`` (``wealy-clews``
  and the cross-attention / concatenation family, which train on the WEALY
  item format);
- ``"two_stream"``: ``(whisper_seq, whisper_mask, clews_seq, clews_mask) ->
  (z, z_whisper, z_clews)`` (``whisper-clews``, ``multimodal-two-stream``).

Flax infers every input width at init; torch needs them when the module
is built: ``in_features`` (the whisper sequence's width, 1280 at
large-v3-turbo), ``wealy_features`` (the WEALY chunk vector's, 512) and
``clews_features`` (the CLEWS sequence's, 2048).
"""

from __future__ import annotations

from wealy_tpu_torch.models.fusion import (
    ConcatFusion,
    CrossAttentionFusion,
    TwoStreamModel,
    WealyClewsModel,
    WealyQueryFusion,
)
from wealy_tpu_torch.models.heads import ProjectionHead

MODEL_NAMES = (
    "whisper",
    "wealy-clews",
    "whisper-clews",
    "multimodal-cross-attention",
    "multimodal-concatenation",
    "multimodal-cross-attention-residual",
    "multimodal-two-stream",
)


def model_signature(name: str) -> str:
    """The call signature of ``name`` (see the module docstring); a name the
    registry does not know raises ``KeyError``."""
    if name not in MODEL_NAMES:
        raise KeyError(f"unknown model name {name!r}; available: {MODEL_NAMES}")
    if name == "whisper":
        return "single"
    if name in ("whisper-clews", "multimodal-two-stream"):
        return "two_stream"
    return "wealy"


def build_model(name: str, zdim: int = 512, in_features: int = 1280, wealy_features: int = 512,
                clews_features: int = 2048, **kwargs):
    """(module, call signature) for ``conf.model.name``; ``kwargs`` go to the
    module, as in the JAX registry."""
    sig = model_signature(name)
    if name == "whisper":
        return ProjectionHead(in_features, zdim=zdim, **kwargs), sig
    if name == "wealy-clews":
        return WealyClewsModel(wealy_features, clews_features, zdim=zdim, **kwargs), sig
    if sig == "two_stream":
        return TwoStreamModel(in_features, clews_features, zdim=zdim, **kwargs), sig
    # the cross-attention / concatenation family: the WEALY vector is the
    # sequence-fusion module's length-1 query
    if name == "multimodal-concatenation":
        inner = ConcatFusion(wealy_features, clews_features, zdim=zdim, **kwargs)
    else:
        inner = CrossAttentionFusion(wealy_features, clews_features, zdim=zdim,
                                     residual=name.endswith("-residual"), **kwargs)
    return WealyQueryFusion(inner), sig
