"""Model registry keyed by ``conf.model.name``: the counterpart of
``wealy_tpu.models.registry``. This slice ports the single-signature model
``whisper``; the six fusion names come with the CLEWS/fusion slice."""

from __future__ import annotations

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


def check_model_name(name: str) -> None:
    """Raise unless the port builds ``name`` (only ``whisper`` so far)."""
    if name == "whisper":
        return
    if name in MODEL_NAMES:
        raise NotImplementedError(
            f"model {name!r} is a CLEWS/fusion model; the port builds it with the "
            "CLEWS/fusion slice"
        )
    raise KeyError(f"unknown model name {name!r}; available: {MODEL_NAMES}")


def build_model(name: str, zdim: int = 512, in_features: int = 1280, **kwargs):
    """(module, call signature) for ``conf.model.name``; ``"single"`` means
    ``(emb, mask) -> z``. ``in_features`` is the embedding width (flax
    infers it at init; torch needs it to build the first convolution)."""
    check_model_name(name)
    return ProjectionHead(in_features, zdim=zdim, **kwargs), "single"
