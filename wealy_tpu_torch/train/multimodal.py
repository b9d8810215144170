"""Multimodal training adapters, the counterpart of
``wealy_tpu.train.multimodal``: batch flattening and the ``model_call`` of
every ``conf.model.name`` signature, so the train step drives the fusion
models as it drives the single-modal head.

Mask boundary: collates emit ops-convention masks (True = invalid); fusion
models take layer-convention masks (True = valid); the adapters invert
them.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from wealy_tpu_torch.models.registry import build_model
from wealy_tpu_torch.train.step import upcast_batch


def flatten_multimodal_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """(B, n_per_class, ...) multimodal batch -> flat (B*n, ...) with
    ``labels``/``ids``, the layout the losses consume.

    Float leaves become float16, the embedding store's disk dtype (lossless
    for values read from the store, which writes fp16; other values round
    here, as in the JAX package); the step widens them to f32
    (:func:`wealy_tpu_torch.train.step.upcast_batch`)."""
    B, n = batch["version_ids"].shape
    flat = {
        "labels": np.repeat(np.asarray(batch["clique_ids"], np.int32), n),
        "ids": np.asarray(batch["version_ids"], np.int32).reshape(-1),
    }
    for k, v in batch.items():
        if k in ("clique_ids", "version_ids"):
            continue
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            v = v.astype(np.float16)
        flat[k] = v.reshape(B * n, *v.shape[2:])
    return flat


def make_model_call(name: str, model, signature: str) -> Callable:
    """``model_call(model, flat_batch) -> (B*n, zdim)`` embeddings, the batch
    widened to f32 first (numpy arrays or tensors)."""
    del name, model  # the call takes the model it is given (the train state's)
    if signature == "single":

        def call(m, b):
            return m(b["emb"], b["mask"])

    elif signature == "wealy":

        def call(m, b):
            return m(b["wealy"], b["full_clews"], ~b["clews_mask"])  # ops -> layer convention

    elif signature in ("dual", "two_stream"):

        def call(m, b):
            z = m(b["whisper_seq"], ~b["whisper_mask"], b["full_clews"], ~b["clews_mask"])
            return z[0] if signature == "two_stream" else z

    else:
        raise ValueError(f"unknown signature {signature!r}")

    def call_upcast(m, batch):
        # batches ship fp16; model math (pooling, norm statistics) runs in f32
        return call(m, upcast_batch(batch))

    return call_upcast


def build_trainable(name: str, zdim: int = 512, **kwargs) -> Tuple:
    """(model, signature, model_call) for any conf.model.name; ``kwargs``
    carry the input widths (``models/registry.py::build_model``)."""
    model, signature = build_model(name, zdim=zdim, **kwargs)
    return model, signature, make_model_call(name, model, signature)


def input_widths(flat: Dict[str, np.ndarray], signature: str) -> dict:
    """The widths ``build_model`` needs, read from one flat batch."""
    if signature == "single":
        return {"in_features": int(flat["emb"].shape[-1])}
    widths = {"clews_features": int(flat["full_clews"].shape[-1])}
    if signature == "wealy":
        widths["wealy_features"] = int(flat["wealy"].shape[-1])
    else:
        widths["in_features"] = int(flat["whisper_seq"].shape[-1])
    return widths
