"""The port's ``.pt`` export (``EmbeddingStore.save_pt``) against the JAX
package's, on the CPU: the round trips of tests/test_pt_interop.py (a raw
fp16 tensor for a lone ``embeddings`` array, a dict otherwise, strings and
dicts passed through), each file equal byte for byte to the one the JAX
store writes from the same arrays and read back equal by both packages'
loaders; the port's ``EmbeddingDataset`` over a ``.pt``-only tree, with its
``emb_dtype``, ``get_embedding_path``, ``get_audio_path`` and ``epoch``
against the JAX dataset's; and the reference's own ``EmbeddingDataset`` and
its WHISPER-CLEWS and WEALY-CLEWS multimodal datasets (imported through
tests/_ref_import.py; skipped where the reference is not mounted) reading
a tree the port exported, every item equal to the port's loaders and to the
JAX package's bit for bit."""

import csv
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _ref_import import REF, import_ref
from wealy_tpu.data.dataset import EmbeddingDataset as JEmbeddingDataset
from wealy_tpu.data.embedding_store import EmbeddingStore as JStore
from wealy_tpu.data.embedding_store import load_pt as j_load_pt
from wealy_tpu.data.multimodal import WealyClewsDataset as JWealyClewsDataset
from wealy_tpu.data.multimodal import WhisperClewsDataset as JWhisperClewsDataset
from wealy_tpu.train.config import Config as JConfig
from wealy_tpu_torch.data.dataset import EmbeddingDataset
from wealy_tpu_torch.data.embedding_store import EmbeddingStore, load_pt
from wealy_tpu_torch.data.multimodal import WealyClewsDataset, WhisperClewsDataset
from wealy_tpu_torch.train.config import Config

HEADER = ["original_id", "id", "is_cover", "song_text_type", "label"]
ROWS = {
    "train": [(1, 100, False, "o", "A"), (1, 101, True, "c", "A"),
              (2, 200, False, "o", "B"), (2, 201, True, "c", "B")],
    "val": [(3, 300, False, "o", "C"), (3, 301, True, "c", "C")],
    "test": [(4, 400, False, "o", "D"), (4, 401, True, "c", "D"),
             (5, 500, False, "o", "E"), (5, 501, True, "c", "E")],
}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _both_save(tmp_path, version, filename, **arrays):
    """The same arrays exported by the port's store and the JAX store."""
    port = EmbeddingStore(tmp_path / "port", "lyric-covers").save_pt(version, filename, **arrays)
    jax = JStore(tmp_path / "jax", "lyric-covers").save_pt(version, filename, **arrays)
    return port, jax


def test_export_roundtrip_raw(tmp_path, rng):
    emb = rng.normal(size=(7, 16)).astype(np.float32)
    p, j = _both_save(tmp_path, "900", "hs_last_seq.pt", embeddings=emb)
    assert p.read_bytes() == j.read_bytes()
    assert not list(p.parent.glob("*.tmp*"))  # the temporary file was renamed away
    # the reference's format: one raw fp16 tensor
    t = torch.load(p, map_location="cpu", weights_only=True)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float16
    np.testing.assert_array_equal(t.float().numpy(), emb.astype(np.float16).astype(np.float32))
    # both loaders, and both stores through the .npz name, read it back
    for got in (load_pt(p), j_load_pt(p),
                EmbeddingStore(tmp_path / "port", "lyric-covers").load("900", "hs_last_seq.npz"),
                JStore(tmp_path / "port", "lyric-covers").load("900", "hs_last_seq.npz")):
        assert set(got) == {"embeddings"} and got["embeddings"].dtype == np.float32
        np.testing.assert_array_equal(got["embeddings"], t.float().numpy())


def test_export_roundtrip_dict(tmp_path, rng):
    emb = rng.normal(size=(2, 512)).astype(np.float32)
    info = np.array([[0, 0, 0], [0, 0, 1]], np.int64)
    p, j = _both_save(tmp_path, "901", "hs_wealy_concat.pt", embeddings=emb, chunk_info=info)
    assert p.read_bytes() == j.read_bytes()
    obj = torch.load(p, map_location="cpu", weights_only=True)
    assert set(obj) == {"embeddings", "chunk_info"}
    assert obj["embeddings"].dtype == torch.float16 and obj["chunk_info"].dtype == torch.int64
    got, want = load_pt(p), j_load_pt(p)
    for k in ("embeddings", "chunk_info"):
        np.testing.assert_array_equal(got[k], want[k])


def test_export_passes_strings_and_dicts_through(tmp_path, rng):
    """The reference's hs_wealy_concat.pt carries a str and a dict beside
    the tensor (multimodal_dataset.py:110-126): both stay as they are."""
    emb = rng.normal(size=(3, 16)).astype(np.float32)
    p, j = _both_save(tmp_path, "902", "hs_wealy_concat.pt", embeddings=emb,
                      chunk_info={"total_chunks": 3}, extraction_method="chunked")
    assert p.read_bytes() == j.read_bytes()
    obj = torch.load(p, map_location="cpu", weights_only=False)
    assert obj["extraction_method"] == "chunked" and obj["chunk_info"] == {"total_chunks": 3}
    bools = EmbeddingStore(tmp_path / "port", "lyric-covers").save_pt(
        "903", "hs_clews_mask.pt", embeddings=np.zeros(6, bool))
    mask = torch.load(bools, map_location="cpu", weights_only=True)
    assert mask.dtype == torch.bool and not mask.any()


def _write_csvs(lc: Path) -> None:
    lc.mkdir(parents=True)
    for split, rows in ROWS.items():
        with open(lc / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(HEADER)
            w.writerows(rows)


def _conf(tmp_path, **data) -> dict:
    return {
        "path": {"lyric_covers_data": str(tmp_path / "lc"), "hidden_states": str(tmp_path / "hs"),
                 "data": str(tmp_path / "data"), "cache": str(tmp_path / "cache")},
        "data": {"dataset_name": "lyric-covers", "embedding_type": "last_hidden_states",
                 "embedding_format": "concat", "chunk_size": 8, **data},
        "model": {"name": "whisper-clews", "zdim": 16},
    }


def test_dataset_over_pt_tree_and_its_accessors(tmp_path, rng):
    """EmbeddingDataset over a .pt-only tree: items, ``emb_dtype``, the path
    accessors and ``epoch`` as the JAX dataset gives them."""
    _write_csvs(tmp_path / "lc")
    store = EmbeddingStore(tmp_path / "hs", "lyric-covers")
    for rows in ROWS.values():
        for _, vid, *_ in rows:
            store.save_pt(str(vid), "hs_last_seq.pt",
                          embeddings=rng.normal(size=(10, 24)).astype(np.float32))
    audio = tmp_path / "data" / "LyricCovers" / "audio" / "100"
    audio.mkdir(parents=True)
    (audio / "100_audio.mp3").touch()
    conf = _conf(tmp_path)
    ds = EmbeddingDataset(Config.from_dict(conf), "train", seed=0)
    jds = JEmbeddingDataset(JConfig.from_dict(conf), "train", seed=0)
    label, versions = ds[0]
    assert versions[0][1].shape == (10, 24) and versions[0][1].dtype == np.float32
    for v in ds.sampler.versions:
        np.testing.assert_array_equal(ds.load_embedding(v), jds.load_embedding(v))
        assert ds.get_embedding_path(v) == jds.get_embedding_path(v)
        assert ds.get_embedding_path(v).suffix == ".pt"
        assert ds.get_audio_path(v) == jds.get_audio_path(v)
    assert ds.get_audio_path("100") is not None
    half = EmbeddingDataset(Config.from_dict(conf), "train", seed=0, emb_dtype=np.float16)
    jhalf = JEmbeddingDataset(JConfig.from_dict(conf), "train", seed=0, emb_dtype=np.float16)
    for v in half.sampler.versions:
        got, want = half.load_embedding(v), jhalf.load_embedding(v)
        assert got.dtype == want.dtype == np.float16
        np.testing.assert_array_equal(got, want)
    got = [[(i, emb.tolist()) for i, emb in item[1]] for b in ds.epoch(batch_size=2)
           for item in b]
    want = [[(i, emb.tolist()) for i, emb in item[1]] for b in jds.epoch(batch_size=2)
            for item in b]
    assert got == want and got
    # p_samesong / augment override the config's, as in JAX
    kw = dict(seed=3, n_per_class=2, p_samesong=1.0, augment=False)
    a = EmbeddingDataset(Config.from_dict(conf), "train", **kw)
    b = JEmbeddingDataset(JConfig.from_dict(conf), "train", **kw)
    assert a.sampler.p_samesong == b.sampler.p_samesong == 1.0
    assert a.sampler.augment is b.sampler.augment is False
    nopath = {**conf, "path": {**conf["path"], "data": ""}}
    assert EmbeddingDataset(Config.from_dict(nopath), "train").get_audio_path("100") is None


# ---------------------------------------------------------------------------
# The reference's own dataset classes (executed, not transcribed) read a tree
# the port exported with save_pt; every item equals the port's loaders and
# the JAX package's.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_lib():
    if not (REF / "lib" / "embedding_dataset" / "base_dataset.py").exists():
        pytest.skip("reference library not mounted")
    if "omegaconf" not in sys.modules:
        # the reference only calls OmegaConf.select(conf, 'path.meta')
        class _OC:
            @staticmethod
            def select(cfg, key, default=None):
                cur = cfg
                for part in key.split("."):
                    cur = getattr(cur, part, None)
                    if cur is None:
                        return default
                return cur

        mod = types.ModuleType("omegaconf")
        mod.OmegaConf = _OC
        sys.modules["omegaconf"] = mod
    base = import_ref("embedding_dataset.base_dataset")
    mm = import_ref("embedding_dataset.multimodal_dataset")
    return (base.EmbeddingDataset, mm.MultimodalEmbeddingDataset_WEALYCLEWS,
            mm.MultimodalEmbeddingDataset_WHISPERCLEWS)


@pytest.fixture
def exported_project(tmp_path, rng):
    """CSVs and a .pt tree exported entirely through the port's save_pt;
    (port Config, JAX Config)."""
    _write_csvs(tmp_path / "lc")
    # the reference's build pipeline runs its audio filter: a file per version
    audio = tmp_path / "data" / "LyricCovers" / "audio"
    store = EmbeddingStore(tmp_path / "hs", "lyric-covers")
    for rows in ROWS.values():
        for _, vid, *_ in rows:
            vid = str(vid)
            (audio / vid).mkdir(parents=True, exist_ok=True)
            (audio / vid / f"{vid}_audio.mp3").touch()
            T = int(rng.integers(6, 12))
            store.save_pt(vid, "hs_last_seq.pt",
                          embeddings=rng.normal(size=(T, 24)).astype(np.float32))
            store.save_pt(vid, "hs_wealy_concat.pt",
                          embeddings=rng.normal(size=(3, 16)).astype(np.float32),
                          chunk_info={"total_chunks": 3}, extraction_method="chunked")
            store.save_pt(vid, "hs_clews.pt", embeddings=rng.normal(size=(6, 12)).astype(np.float32))
            store.save_pt(vid, "hs_clews_avg.pt", embeddings=rng.normal(size=(12,)).astype(np.float32))
            store.save_pt(vid, "hs_clews_mask.pt", embeddings=np.zeros(6, bool))
    conf = _conf(tmp_path)
    conf["path"]["cache"] = str(tmp_path / "refcache")
    conf["data"].pop("chunk_size")
    return Config.from_dict(conf), JConfig.from_dict(conf)


def test_reference_embedding_dataset_over_the_ports_tree(ref_lib, exported_project):
    RefED, _, _ = ref_lib
    conf, jconf = exported_project
    ref_ds = RefED(conf=conf, split="test", verbose=False)
    ours = EmbeddingDataset(conf, "test", seed=0)
    jax = JEmbeddingDataset(jconf, "test", seed=0)
    assert len(ref_ds) == 4
    assert set(ref_ds.versions) == set(ours.sampler.versions) == set(jax.sampler.versions)
    for v in ref_ds.versions:
        assert ref_ds.info[v]["id"] == int(ours.metadata.info[v]["id"])  # MD5-int31 ids
        ref_emb = ref_ds.load_embedding(v)
        assert ref_emb.dtype == torch.float32  # fp16 disk -> fp32
        np.testing.assert_array_equal(ref_emb.numpy(), ours.load_embedding(v))
        np.testing.assert_array_equal(ref_emb.numpy(), jax.load_embedding(v))
    item = ref_ds[0]  # [icl, i1, emb1, i2, emb2]
    v1 = ref_ds.versions[0]
    assert item[1] == ref_ds.info[v1]["id"]
    np.testing.assert_array_equal(item[2].numpy(), ours.load_embedding(v1))


def test_reference_whisperclews_over_the_ports_tree(ref_lib, exported_project):
    _, _, RefWC = ref_lib
    conf, jconf = exported_project
    ref_ds = RefWC(conf=conf, split="test", verbose=False)
    ours = WhisperClewsDataset(conf, "test", seed=0)
    jax = JWhisperClewsDataset(jconf, "test", seed=0)
    assert list(ref_ds.versions) == list(ours.sampler.versions) == list(jax.sampler.versions)
    for v in ref_ds.versions:
        w, wm, fc, ac, cm = ref_ds.load_multimodal_embeddings(v)
        mm, jmm = ours.load_multimodal(v), jax.load_multimodal(v)
        for ref, key in ((w, "whisper_seq"), (fc, "full_clews"), (ac, "avg_clews"),
                         (cm, "clews_mask")):
            np.testing.assert_array_equal(ref.numpy(), mm[key])
            np.testing.assert_array_equal(mm[key], jmm[key])
        assert wm.all()  # the reference marks every real row valid
        assert fc.shape == (6, 12) and ac.shape == (12,)  # no dummy fallback
    assert not ours.dummy_log


def test_reference_wealyclews_over_the_ports_tree(ref_lib, exported_project):
    _, RefWC, _ = ref_lib
    conf, jconf = exported_project
    ref_ds = RefWC(conf=conf, split="test", verbose=False)
    ours = WealyClewsDataset(conf, "test", seed=0)
    jax = JWealyClewsDataset(jconf, "test", seed=0)
    assert list(ref_ds.versions) == list(ours.sampler.versions) == list(jax.sampler.versions)
    for v in ref_ds.versions:
        wealy, fc, ac, cm = ref_ds.load_multimodal_embeddings(v)
        mm, jmm = ours.load_multimodal(v), jax.load_multimodal(v)
        assert wealy["extraction_method"] == "chunked"  # not 'dummy'
        assert wealy["chunk_info"]["total_chunks"] == 3
        np.testing.assert_array_equal(wealy["embeddings"].numpy(), mm["wealy"]["embeddings"])
        np.testing.assert_array_equal(mm["wealy"]["embeddings"], jmm["wealy"]["embeddings"])
        np.testing.assert_array_equal(fc.numpy(), mm["full_clews"])
        np.testing.assert_array_equal(mm["full_clews"], jmm["full_clews"])
    item = ref_ds[0]  # [icl, i1, {wealy, full_clews, ...}, ...]
    assert item[2]["wealy"]["extraction_method"] == "chunked"
