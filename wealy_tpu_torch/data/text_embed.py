"""Text (lyrics) embedding stage, the ``hs_sbert`` taxonomy entry, a copy of
``wealy_tpu.data.text_embed``.

The reference consumes sentence-transformer embeddings (``hs_sbert.pt``,
base_dataset.py:120-121) made outside its repository. This module makes
them with one of two backends:

- :class:`HFTextEmbedder`: a Hugging Face encoder from a LOCAL model
  directory (mean-pooled last hidden state, L2-normalised: the
  sentence-transformers recipe); ``transformers`` is imported when one is
  built, and nothing is downloaded.
- :class:`HashedNgramEmbedder`: character n-gram feature hashing into a
  fixed dimension, L2-normalised, bit-equal to the JAX package's. Not a
  semantic model, but a reproducible text representation that needs no
  weights.

Both write store entries shaped (1, dim), the SBERT-like layout that the
collates single out (collate_functions.py:174-195 "is_sbert_like").
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Optional, Protocol, Sequence

import numpy as np

from wealy_tpu_torch import resolve_device


class TextEmbedder(Protocol):
    dim: int

    def embed(self, texts: Sequence[str]) -> np.ndarray:  # (N, dim)
        ...


class HashedNgramEmbedder:
    """Character n-gram feature hashing -> fixed-dim L2-normalised vectors."""

    def __init__(self, dim: int = 384, n_min: int = 3, n_max: int = 5):
        self.dim = dim
        self.n_min = n_min
        self.n_max = n_max

    def _features(self, text: str) -> Iterable[str]:
        t = " " + " ".join(text.lower().split()) + " "
        for n in range(self.n_min, self.n_max + 1):
            for i in range(max(0, len(t) - n + 1)):
                yield t[i : i + n]

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for row, text in enumerate(texts):
            for feat in self._features(text or ""):
                h = hashlib.blake2b(feat.encode("utf-8"), digest_size=8).digest()
                idx = int.from_bytes(h[:4], "little") % self.dim
                sign = 1.0 if h[4] & 1 else -1.0
                out[row, idx] += sign
            norm = np.linalg.norm(out[row])
            if norm > 0:
                out[row] /= norm
        return out


class HFTextEmbedder:
    """Mean-pooled transformer encoder from a LOCAL checkpoint directory, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, model_dir: str, max_length: int = 256, device=None):
        from transformers import AutoModel, AutoTokenizer

        self.device = resolve_device(device)
        self.tokenizer = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
        self.model = AutoModel.from_pretrained(model_dir, local_files_only=True).eval()
        self.model.to(self.device)
        self.max_length = max_length
        self.dim = self.model.config.hidden_size

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        import torch

        with torch.no_grad():
            enc = self.tokenizer(
                list(texts),
                padding=True,
                truncation=True,
                max_length=self.max_length,
                return_tensors="pt",
            )
            enc = {k: v.to(self.device) for k, v in enc.items()}
            hidden = self.model(**enc).last_hidden_state  # (N, T, D)
            mask = enc["attention_mask"].unsqueeze(-1).float()
            pooled = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
            pooled = torch.nn.functional.normalize(pooled, dim=-1)
        return pooled.cpu().numpy().astype(np.float32)


def extract_text_embeddings(
    embedder: TextEmbedder,
    store,
    texts_by_version: dict[str, Optional[str]],
    filename: str = "hs_sbert.npz",
    batch_size: int = 64,
) -> dict:
    """Embed transcriptions per version and write (1, dim) entries into
    ``store`` (an :class:`~wealy_tpu_torch.data.embedding_store.EmbeddingStore`).

    Versions with missing or empty text are skipped and reported.
    """
    keys = [k for k, t in texts_by_version.items() if t]
    skipped = [k for k, t in texts_by_version.items() if not t]
    for start in range(0, len(keys), batch_size):
        chunk = keys[start : start + batch_size]
        vecs = embedder.embed([texts_by_version[k] for k in chunk])
        for k, v in zip(chunk, vecs):
            store.save(k, filename, embeddings=v[None, :])
    return {"done": keys, "skipped_no_text": skipped}
