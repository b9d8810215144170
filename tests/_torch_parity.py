"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
the card check, row cosine, and one seeded weight set carried from the JAX
model into the port through ``state_dict_from_jax_params``."""

from __future__ import annotations

import numpy as np
import pytest
import torch


def cuda_device() -> torch.device:
    """The card, or skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel tests run on the card)")
    return torch.device("cuda")


def min_row_cosine(a, b) -> float:
    """Smallest cosine similarity between matching rows (last axis)."""
    a = np.asarray(a, np.float64).reshape(-1, np.shape(a)[-1])
    b = np.asarray(b, np.float64).reshape(-1, np.shape(b)[-1])
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return float(np.min(num / np.maximum(den, 1e-30)))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def jax_and_port_whisper(cfg, dtype: str, seed: int = 0, scan_layers: bool = False):
    """(jax_model, jax_params, port_model) with identical weights: the JAX
    model's seeded init, converted by state_dict_from_jax_params.
    ``dtype`` is "float32" or "bfloat16" for both sides."""
    import jax
    import jax.numpy as jnp

    from wealy_tpu.models.whisper.model import Whisper as JWhisper
    from wealy_tpu_torch.models.whisper.convert import state_dict_from_jax_params
    from wealy_tpu_torch.models.whisper.model import Whisper

    jmodel = JWhisper(cfg, dtype=getattr(jnp, dtype), scan_layers=scan_layers)
    mel0 = jnp.zeros((1, cfg.n_mels, 2 * cfg.n_audio_ctx), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), mel0, jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = Whisper(cfg, dtype=getattr(torch, dtype))
    port.load_state_dict(state_dict_from_jax_params(params))
    return jmodel, params, port.eval()


# the toy vocabulary's merges: a few English pairs over the 256 byte tokens
TOY_MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("l", "l"), ("ll", "o"), ("Ġ", "a"),
              ("i", "n"), ("Ġ", "s"), ("e", "r"), ("o", "u")]


def write_toy_vocab(path, special: dict = None, words: int = 0):
    """A byte-level BPE vocabulary in ``path`` (vocab.json, merges.txt,
    special_tokens.json): the 256 byte tokens (id = byte value), then one
    token per merge of :data:`TOY_MERGES`, then (up to id ``words``) one
    word "Ġw<id>" per id, and ``special`` ({token: id})."""
    import json
    from pathlib import Path

    from wealy_tpu_torch.data.tokenizer import _bytes_to_unicode

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    b2u = _bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    for a, b in TOY_MERGES:
        vocab[a + b] = len(vocab)
    for i in range(len(vocab), words):
        vocab[f"Ġw{i}"] = i
    special = dict(special or {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258})
    vocab.update(special)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in TOY_MERGES) + "\n")
    (path / "special_tokens.json").write_text(json.dumps(special))
    return path
