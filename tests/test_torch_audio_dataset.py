"""The port's raw-audio dataset stack (wealy_tpu_torch.data.audio_dataset,
.transcription) against the JAX package's over one WAV tree: the cases of
tests/test_audio_dataset.py run through both packages' AudioDataset,
audio_collate and create_audio_loader and must give equal items and
batches; the transcription validator decides a list of texts as the JAX one
does, and the cache reads, persists and reloads the same way."""

import csv
import wave

import numpy as np
import pytest

import wealy_tpu.data.audio_dataset as JAD
import wealy_tpu_torch.data.audio_dataset as TAD
from wealy_tpu.data.metadata import load_lyric_covers as j_load_lyric_covers
from wealy_tpu.data.transcription import TranscriptionCache as JCache
from wealy_tpu.data.transcription import TranscriptionValidator as JValidator
from wealy_tpu_torch.data.metadata import load_lyric_covers
from wealy_tpu_torch.data.transcription import TranscriptionCache, TranscriptionValidator


def _write_wav(path, seconds, sr=16000, freq=440.0):
    path.parent.mkdir(parents=True, exist_ok=True)
    t = np.arange(int(seconds * sr)) / sr
    x = (np.sin(2 * np.pi * freq * t) * 0.5 * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """tests/test_audio_dataset.py's fixture: four train versions in two
    cliques (201's audio missing), two val versions, two transcriptions (one
    valid, one only musical symbols); both packages see the same files."""
    lc = tmp_path / "lc"
    lc.mkdir()
    rows = {
        "train": [(1, 100, False, "o", "A"), (1, 101, True, "c", "A"),
                  (2, 200, False, "o", "B"), (2, 201, True, "c", "B")],
        "val": [(3, 300, False, "o", "C"), (3, 301, True, "c", "C")],
        "test": [],
    }
    for split, data in rows.items():
        with open(lc / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["original_id", "id", "is_cover", "song_text_type", "label"])
            w.writerows(data)
    base = tmp_path / "data" / "LyricCovers" / "audio"
    for key in ("100", "101", "200", "300", "301"):
        _write_wav(base / key / f"{key}_audio.mp3", seconds=1.0 + int(key) % 3)
    trans = tmp_path / "trans"
    trans.mkdir()
    (trans / "100.txt").write_text(
        "The quick brown fox jumps over the lazy dog tonight and sings a new song. "
        "Every day brings another melody worth keeping around here."
    )
    (trans / "101.txt").write_text("♪♪♪♪♪")
    sides = {}
    for name, mod, load_md, cache_cls in (("port", TAD, load_lyric_covers, TranscriptionCache),
                                         ("jax", JAD, j_load_lyric_covers, JCache)):
        cache = cache_cls(tmp_path / "tc" / name, "lyric-covers", "turbo", "train")
        cache.build_index(trans)
        sides[name] = (mod, load_md(lc), cache)
    return tmp_path / "data", sides


def _datasets(tree, split="train", **kw):
    root, sides = tree
    out = []
    for mod, md, cache in sides.values():
        out.append(mod.AudioDataset(md, split, root, transcription_cache=cache, **kw))
    return out


def _same_item(a, b):
    for field in ("clique_idx", "version_idx", "transcription", "has_valid_transcription",
                  "version_key"):
        assert getattr(a, field) == getattr(b, field), field
    assert (a.audio_path is None) == (b.audio_path is None)
    if b.waveform is None:
        assert a.waveform is None
    else:
        np.testing.assert_array_equal(a.waveform, b.waveform)


@pytest.mark.parametrize("split,kw", [("train", {}), ("val", {}), ("train", {"debug_num_cliques": 1}),
                                      ("train", {"evaluation_mode": True})])
def test_items_equal_to_jax(tree, split, kw):
    port, jax = _datasets(tree, split, **kw)
    assert port.versions == jax.versions and len(port) == len(jax)
    for i in range(len(jax)):
        _same_item(port[i], jax[i])
    got, want = port.evaluation_tensors(), jax.evaluation_tensors()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert port.check_clique_versions() == jax.check_clique_versions()


@pytest.mark.parametrize("case", ["fields", "missing_is_silence", "evaluation_mode", "debug",
                                  "clique_check"])
def test_the_jax_dataset_cases(tree, case):
    """tests/test_audio_dataset.py::TestAudioDataset on the port."""
    root, sides = tree
    _, md, cache = sides["port"]
    if case == "fields":
        ds = TAD.AudioDataset(md, "train", root, transcription_cache=cache)
        item = ds[ds.versions.index("100")]
        assert item.waveform is not None and item.waveform.ndim == 1
        assert item.has_valid_transcription and item.audio_path is not None
        assert not ds[ds.versions.index("101")].has_valid_transcription
    elif case == "missing_is_silence":
        ds = TAD.AudioDataset(md, "train", root, transcription_cache=cache)
        item = ds[ds.versions.index("201")]
        np.testing.assert_array_equal(item.waveform, np.zeros(16000, np.float32))
        assert item.audio_path is None
    elif case == "evaluation_mode":
        ds = TAD.AudioDataset(md, "train", root, evaluation_mode=True)
        assert ds[0].waveform is None
        assert ds.evaluation_tensors()["clique_idx"].shape == (4,)
    elif case == "debug":
        assert len(TAD.AudioDataset(md, "train", root, debug_num_cliques=1)) == 2
    else:
        report = TAD.AudioDataset(md, "train", root).check_clique_versions()
        assert report["ok"] and report["n_cliques"] == 2


def test_a_file_that_does_not_decode_is_silence(tree):
    """A version whose file exists but does not decode (an empty file under
    the mp3 name) degrades to 1 s of silence, as a missing one does."""
    root, sides = tree
    (root / "LyricCovers" / "audio" / "200" / "200_audio.mp3").write_bytes(b"")
    port, jax = _datasets(tree)
    i = port.versions.index("200")
    np.testing.assert_array_equal(port[i].waveform, np.zeros(16000, np.float32))
    _same_item(port[i], jax[i])


def _same_batch(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("kw", [{}, {"enforce_max_duration": True, "max_seconds": 1},
                                {"length_buckets": [16000, 65536, 131072]},
                                {"length_buckets": [8000]}])
def test_collate_equal_to_jax(tree, kw):
    port, jax = _datasets(tree)
    got = TAD.audio_collate([port[i] for i in range(len(port))], **kw)
    want = JAD.audio_collate([jax[i] for i in range(len(jax))], **kw)
    _same_batch(got, want)
    B, T = got["waveforms"].shape
    assert B == 4
    for i in range(B):
        L = min(got["lengths"][i], T)
        assert got["attention_mask"][i, :L].all() and not got["attention_mask"][i, L:].any()


@pytest.mark.parametrize("items", ["empty", "malformed"])
def test_collate_drops_what_it_cannot_pad(tree, items):
    port, jax = _datasets(tree)
    if items == "empty":
        got, want = TAD.audio_collate([]), JAD.audio_collate([])
        assert got["waveforms"].shape == (0, 0)
    else:
        got = TAD.audio_collate([port[0], port[1], TAD.AudioItem(0, 0, None, None, False, None,
                                                                  "broken")])
        want = JAD.audio_collate([jax[0], jax[1], JAD.AudioItem(0, 0, None, None, False, None,
                                                                 "broken")])
        assert got["waveforms"].shape[0] == 2
    _same_batch(got, want)


@pytest.mark.parametrize("split,kw,n_batches,first", [
    ("train", {"batch_size": 3, "seed": 1}, 1, 3),  # shuffled, the tail dropped
    ("val", {"batch_size": 4}, 1, 2),  # in order, the tail kept
    ("train", {"batch_size": 2, "shuffle": False, "drop_last": False}, 2, 2),
])
def test_loader_equal_to_jax(tree, split, kw, n_batches, first):
    port, jax = _datasets(tree, split)
    got = list(TAD.create_audio_loader(port, **kw))
    want = list(JAD.create_audio_loader(jax, **kw))
    assert len(got) == len(want) == n_batches and got[0]["waveforms"].shape[0] == first
    for g, w in zip(got, want):
        _same_batch(g, w)


TEXTS = [
    "",
    "   ",
    None,
    "♪♪♪♪♪",
    "♪ la la ♪",
    "(music playing) the rest of it goes here with plenty of words to count",
    "[instrumental]",
    "la la la la la la la la la la la la",
    "na na na na hey hey hey goodbye na na na na hey hey hey goodbye",
    "The quick brown fox jumps over the lazy dog tonight and sings a new song. "
    "Every day brings another melody worth keeping around here.",
    "I love you. I love you. I love you. I love you. Forever and ever my dear.",
    "hold me close hold me close hold me close hold me close hold me close now",
    "um uh ah the [00:12] river (softly) runs to the sea and the sea runs on forever again",
    "short text",
    "!!! ??? ... ---",
    "Walking down the road I see the lights, shining bright on summer nights; "
    "we were young and we were free, and it was all we'd ever need.",
    "doo doo doo bah bah hmm mm doo doo bah doo doo",
    "Ah ah ah ah ah ah ah ah ah ah ah ah ah",
]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_validator_decides_as_jax(i):
    text = TEXTS[i]
    for kw in ({}, {"min_words": 4, "max_repetition_ratio": 0.3}):
        port, jax = TranscriptionValidator(**kw), JValidator(**kw)
        assert port.is_valid_transcription(text) == jax.is_valid_transcription(text)
        assert port.get_validation_details(text) == jax.get_validation_details(text)
        assert port.clean_text(text) == jax.clean_text(text)


def test_cache_persists_and_reloads_as_jax(tmp_path):
    root = tmp_path / "trans" / "turbo"
    root.mkdir(parents=True)
    (root / "a.txt").write_text("one two three four five six seven eight nine ten eleven")
    (root / "b.txt").write_text("♪")
    keys = ["a", "b", "missing"]
    census = {}
    for name, cls in (("port", TranscriptionCache), ("jax", JCache)):
        cache = cls(tmp_path / name, "lyric-covers", "turbo", "train")
        assert cache.build_index(tmp_path / "trans") == 2
        census[name] = cache.validate_all(keys)
        cache.save_disk_cache()
        again = cls(tmp_path / name, "lyric-covers", "turbo", "train")
        assert again.load_disk_cache() and again.get("a") == cache.get("a")
        assert again.cache_file.name == "lyric-covers_turbo_train_cache.json"
    assert census["port"] == census["jax"]
    assert census["port"]["a"]["has_valid_transcription"]
    assert census["port"]["missing"]["details"]["issues"] == ["missing"]
