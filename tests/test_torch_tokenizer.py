"""The port's byte-level BPE tokenizer (wealy_tpu_torch.data.tokenizer) and
lyrics text stage (wealy_tpu_torch.data.text_embed) against the JAX
package's: one toy vocabulary (the 256 byte tokens and a few merges,
written by the test), the same texts through both. Every comparison is
exact: the tokenizer and the hashed embedder are host code copied from the
JAX package, and the store rounds to f16 with the same cast."""

import numpy as np
import pytest

from wealy_tpu.data.embedding_store import EmbeddingStore as JStore
from wealy_tpu.data.text_embed import HashedNgramEmbedder as JHashed
from wealy_tpu.data.text_embed import extract_text_embeddings as j_extract
from wealy_tpu.data.tokenizer import ByteLevelBPE as JBPE
from wealy_tpu_torch.data.embedding_store import EmbeddingStore
from wealy_tpu_torch.data.text_embed import (
    HashedNgramEmbedder,
    HFTextEmbedder,
    extract_text_embeddings,
)
from wealy_tpu_torch.data.tokenizer import ByteLevelBPE

from _torch_parity import write_toy_vocab

TEXTS = [
    "the hello world",
    "hello, hello!  the  rain in spain   ",
    "Ça va? naïve café — déjà vu ♪♪ 「歌詞」 🎵",
    "don't we'll they've I'm",
    "",
    "\n\ttabs and\nnewlines\n",
]


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    path = write_toy_vocab(tmp_path_factory.mktemp("vocab"))
    return ByteLevelBPE.from_dir(path), JBPE.from_dir(path)


@pytest.mark.parametrize("text", TEXTS)
def test_encode_decode_equal_jax(toks, text):
    port, jax = toks
    ids = port.encode(text)
    assert ids == jax.encode(text)
    assert port.decode(ids) == jax.decode(ids) == text
    assert port.decode(ids, skip_special=False) == jax.decode(ids, skip_special=False)


def test_merges_and_specials(toks):
    port, jax = toks
    ids = port.encode(" the hello")
    # " the" is one merged token, then " " "he" "llo" (no merge takes "Ġh")
    assert [port.ids_to_tokens[i] for i in ids] == ["Ġthe", "Ġ", "he", "llo"]
    with_special = [50258] + ids + [50257, 123456]
    assert port.decode(with_special) == jax.decode(with_special) == " the hello"
    assert port.decode(with_special, skip_special=False) == jax.decode(
        with_special, skip_special=False) == "<|startoftranscript|> the hello<|endoftext|>"


@pytest.mark.parametrize("dim,n_min,n_max", [(384, 3, 5), (48, 2, 4)])
def test_hashed_ngram_bit_equal(dim, n_min, n_max):
    got = HashedNgramEmbedder(dim, n_min, n_max).embed(TEXTS)
    want = JHashed(dim, n_min, n_max).embed(TEXTS)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if n_min > 2:
        np.testing.assert_array_equal(got[4], 0.0)  # empty text: no n-gram


def test_extract_text_embeddings_writes_the_jax_npz(tmp_path):
    texts = {f"{100 + i}": t for i, t in enumerate(TEXTS)} | {"200": None}
    port_store = EmbeddingStore(tmp_path / "p", "lyric-covers")
    jax_store = JStore(tmp_path / "j", "lyric-covers")
    got = extract_text_embeddings(HashedNgramEmbedder(64), port_store, texts, batch_size=4)
    want = j_extract(JHashed(64), jax_store, texts, batch_size=4)
    assert got == want
    assert got["skipped_no_text"] == ["104", "200"]
    for v in got["done"]:
        a = np.load(port_store.version_dir(v) / "hs_sbert.npz")
        b = np.load(jax_store.version_dir(v) / "hs_sbert.npz")
        assert set(a.files) == set(b.files) == {"embeddings"}
        assert a["embeddings"].shape == (1, 64) and a["embeddings"].dtype == np.float16
        np.testing.assert_array_equal(a["embeddings"], b["embeddings"])


def test_hf_embedder_needs_a_card_or_cpu_and_a_local_directory(tmp_path, monkeypatch):
    """The HF backend resolves its device through resolve_device (the card
    unless asked for the CPU) and reads only a local directory."""
    import sys
    import types

    import torch

    calls = []

    class Loader:
        @staticmethod
        def from_pretrained(path, **kw):
            calls.append(kw)
            raise OSError(f"no model directory {path}")

    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(AutoModel=Loader, AutoTokenizer=Loader))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HFTextEmbedder(str(tmp_path))
    with pytest.raises(OSError, match="no model directory"):
        HFTextEmbedder(str(tmp_path), device="cpu")
    assert calls == [{"local_files_only": True}]
