"""CPU parity of the port's data stack (wealy_tpu_torch.train.config and
wealy_tpu_torch.data) against the JAX package on the fixture of
tests/test_cli.py::project and small CSVs of the other datasets: the same
Config, Metadata, ids, filters, stores, sampler order and collates, with
arrays equal."""

import copy
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from wealy_tpu.data import chunking as jchunking
from wealy_tpu.data import dataset as jdataset
from wealy_tpu.data import filters as jfilters
from wealy_tpu.data import ids as jids
from wealy_tpu.data import metadata as jmetadata
from wealy_tpu.data.embedding_store import EmbeddingStore as JStore
from wealy_tpu.data.packed_store import pack_from_store
from wealy_tpu.data.sampler import CliqueSampler as JSampler
from wealy_tpu.train.config import Config as JConfig
from wealy_tpu_torch.data import chunking, dataset, filters, ids, metadata
from wealy_tpu_torch.data.embedding_store import EmbeddingStore
from wealy_tpu_torch.data.packed_store import PackedStore
from wealy_tpu_torch.data.sampler import CliqueSampler
from wealy_tpu_torch.train.config import Config, resolve_interpolations

from test_cli import project  # noqa: F401  (the shared fixture)


def _port_md(md):
    return metadata.Metadata(md.dataset_name, copy.deepcopy(md.info), copy.deepcopy(md.splits))


def _same_md(a, b):
    assert a.dataset_name == b.dataset_name
    assert json.dumps(a.info) == json.dumps(b.info)  # values, types and key order
    assert json.dumps(a.splits) == json.dumps(b.splits)


def test_config_json(project):  # noqa: F811
    _, cpath, _ = project
    assert Config.from_file(cpath).to_dict() == JConfig.from_file(cpath).to_dict()


def test_config_yaml_interpolation(tmp_path):
    pytest.importorskip("yaml")
    text = (
        "path:\n  working_dir: /data/run\n  cache: ${path.working_dir}/cache\n"
        "data:\n  chunk_size: 500\n  overlap_percentage: 0.5\n"
        "model:\n  name: whisper\n  zdim: ${data.chunk_size}\n"
    )
    p = tmp_path / "conf.yaml"
    p.write_text(text)
    got, want = Config.from_file(p), JConfig.from_file(p)
    assert got.to_dict() == want.to_dict()
    assert got.path.cache == "/data/run/cache" and got.model.zdim == 500
    with pytest.raises(ValueError, match="cycle"):
        resolve_interpolations({"a": "${b}", "b": "${a}"})


def test_lyric_covers_metadata(project):  # noqa: F811
    root, _, _ = project
    _same_md(metadata.load_lyric_covers(root / "lc"), jmetadata.load_lyric_covers(root / "lc"))


def test_shs_metadata(tmp_path):
    pd.DataFrame({"set_id": [1, 1, 2, 2, 3, 10], "ver_id": [5, 6, 7, 8, 9, 1],
                  "title": ["a", "b", "c", "d", "e", "f"]}).to_csv(tmp_path / "shs.csv",
                                                                   index=False)
    splits = tmp_path / "splits"
    splits.mkdir()
    (splits / "SHS100K-TRAIN").write_text("1\t5\tx\n1\t6\ty\n")
    (splits / "SHS100K-VAL").write_text("2\t7\tx\n2\t8\tx\n10\t1\tz\n")
    (splits / "SHS100K-TEST").write_text("3\t9\tx\n2\t8\tx\n")
    got = metadata.load_shs(tmp_path / "shs.csv", splits)
    _same_md(got, jmetadata.load_shs(tmp_path / "shs.csv", splits))
    assert got.splits["test"] == {"3": ["3-9"], "2": ["2-8"]}


def test_discogs_metadata(tmp_path):
    (tmp_path / "id-to-file-mapping.csv").write_text(
        "train,c1,11,yt1,a/b1\ntrain,c1,12,yt2,a/b2\nval,c2,21,yt3,c/d1\n"
        "test,c3,31,yt4,e/f1\ntest,c3,32,yt5,e/f2\nother,c4,41,yt6,g/h\n"
    )
    _same_md(metadata.load_discogs_vi(tmp_path), jmetadata.load_discogs_vi(tmp_path))


def test_metadata_cache_roundtrip(project, tmp_path):  # noqa: F811
    root, _, _ = project
    md = metadata.load_metadata("lyric-covers", lyric_covers_data=str(root / "lc"),
                                meta_cache=str(tmp_path / "meta.json"))
    again = metadata.load_metadata("lyric-covers", meta_cache=str(tmp_path / "meta.json"))
    _same_md(md, again)
    with pytest.raises(ValueError):
        metadata.load_metadata("nope")


def test_ids_and_filters(project):  # noqa: F811
    root, _, _ = project
    jmd = jmetadata.load_lyric_covers(root / "lc")
    tmd = _port_md(jmd)
    present = {"100", "101", "200", "300", "301", "400", "401", "500"}
    for jf, tf, args in [
        (jfilters.remove_versions_without_audio, filters.remove_versions_without_audio,
         ("/nowhere", present.__contains__)),
        (jfilters.remove_single_version_cliques, filters.remove_single_version_cliques, ()),
        (jfilters.remove_overlapping_cliques, filters.remove_overlapping_cliques, ()),
        (jfilters.filter_to_available_embeddings, filters.filter_to_available_embeddings,
         (present.__contains__,)),
    ]:
        assert tf(tmd, *args) == jf(jmd, *args)
        _same_md(tmd, jmd)
    tmd.prune_to_splits()
    jmd.prune_to_splits()
    ids.assign_deterministic_ids(tmd)
    jids.assign_deterministic_ids(jmd)
    _same_md(tmd, jmd)
    assert ids.global_clique_id_mapping(tmd) == jids.global_clique_id_mapping(jmd)
    assert ids.deterministic_song_id("A", "100") == jids.deterministic_song_id("A", "100")


def _with_cache(cpath, cache):
    conf = json.loads(Path(cpath).read_text())
    conf["path"]["cache"] = str(cache)
    p = Path(cache).parent / f"{Path(cache).name}.json"
    p.write_text(json.dumps(conf))
    return p


def test_build_clean_dataset(project, tmp_path):  # noqa: F811
    _, cpath, _ = project
    tconf = Config.from_file(_with_cache(cpath, tmp_path / "tcache"))
    jconf = JConfig.from_file(_with_cache(cpath, tmp_path / "jcache"))
    tmd, tmap = dataset.build_clean_dataset(tconf)
    jmd, jmap = jdataset.build_clean_dataset(jconf)
    _same_md(tmd, jmd)
    assert tmap == jmap
    for split in ("train", "val", "test"):
        assert dataset.validate_data_structures(tmd, split) == \
            jdataset.validate_data_structures(jmd, split)
    # the second build reads the processed cache the first one wrote
    cached, cmap = dataset.build_clean_dataset(tconf)
    _same_md(cached, tmd)
    assert cmap == tmap


def test_store_reads_npz_pt_and_packed(project, tmp_path):  # noqa: F811
    root, cpath, rows = project
    jstore = JStore(root / "hs", "lyric-covers")
    store = EmbeddingStore(root / "hs", "lyric-covers")
    for key in ("100", "401"):
        got, want = store.load(key, "hs_last_seq.npz"), jstore.load(key, "hs_last_seq.npz")
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["embeddings"], want["embeddings"])
        assert got["embeddings"].dtype == np.float32
    assert store.load("100", "missing.npz") is None
    # the port's writer: fp16 on disk, read back by both stores
    emb16 = np.random.default_rng(1).normal(size=(5, 24)).astype(np.float32)
    store.save("999", "hs_last_seq.npz", embeddings=emb16, n=np.arange(3))
    back, jback = store.load("999", "hs_last_seq.npz"), jstore.load("999", "hs_last_seq.npz")
    np.testing.assert_array_equal(back["embeddings"], emb16.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(back["embeddings"], jback["embeddings"])
    np.testing.assert_array_equal(back["n"], np.arange(3))
    # a reference .pt tree (raw tensor and dict payloads)
    pt = JStore(tmp_path / "pt", "lyric-covers")
    emb = np.arange(12, dtype=np.float32).reshape(3, 4)
    pt.save_pt("7", "hs_last_seq.pt", embeddings=emb)
    pt.save_pt("8", "hs_wealy_concat.pt", embeddings=emb, chunk_info=np.arange(3))
    port_pt = EmbeddingStore(tmp_path / "pt", "lyric-covers")
    for key, name in (("7", "hs_last_seq.npz"), ("8", "hs_wealy_concat.npz")):
        got, want = port_pt.load(key, name), pt.load(key, name)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    (port_pt.version_dir("9")).mkdir(parents=True)
    (port_pt.version_dir("9") / "hs_last_seq.npz").write_bytes(b"not a zip")
    assert port_pt.load("9", "hs_last_seq.npz") is None and pt.load("9", "hs_last_seq.npz") is None
    # the packed store, written by the JAX package
    versions = [str(r[1]) for split in rows.values() for r in split]
    pack_from_store(jstore, versions, "hs_last_seq.npz", root / "hs", dataset_name="lyric-covers")
    packed = PackedStore(root / "hs", "hs_last_seq.npz", dataset_name="lyric-covers")
    assert packed.available and len(packed) == len(versions) and "100" in packed
    for key in versions:
        np.testing.assert_array_equal(packed.load(key), jstore.load(key, "hs_last_seq.npz")["embeddings"])
    assert packed.load(key, dtype=np.float16).dtype == np.float16
    assert packed.load("nope") is None
    ds = dataset.EmbeddingDataset(Config.from_file(_with_cache(cpath, tmp_path / "c")), "test")
    assert ds.packed is not None
    np.testing.assert_array_equal(ds.load_embedding("400"), packed.load("400"))
    # a binary that no longer matches its manifest is ignored
    bin_path = packed.bin_path
    bin_path.write_bytes(bin_path.read_bytes()[:-2])
    assert not PackedStore(root / "hs", "hs_last_seq.npz", dataset_name="lyric-covers").available


def test_sampler_order_and_items(project, tmp_path):  # noqa: F811
    _, cpath, _ = project
    tds = dataset.EmbeddingDataset(Config.from_file(_with_cache(cpath, tmp_path / "t")), "train")
    jds = jdataset.EmbeddingDataset(JConfig.from_file(_with_cache(cpath, tmp_path / "j")), "train")
    assert tds.sampler.versions == jds.sampler.versions
    assert tds.sampler.labels == jds.sampler.labels
    assert len(tds) == len(jds) == 4
    ts = CliqueSampler(tds.metadata, "train", tds.load_embedding, n_per_class=3, p_samesong=0.3,
                       augment=True, seed=5)
    js = JSampler(jds.metadata, "train", jds.load_embedding, n_per_class=3, p_samesong=0.3,
                  augment=True, seed=5)
    for tb, jb in zip(ts.epoch(batch_size=2), js.epoch(batch_size=2)):
        for (tl, tv), (jl, jv) in zip(tb, jb):
            assert tl == jl and [i for i, _ in tv] == [i for i, _ in jv]
            for (_, te), (_, je) in zip(tv, jv):
                np.testing.assert_array_equal(te, je)
    assert ts.n_batches(3) == js.n_batches(3) == 1


@pytest.mark.parametrize("chunk_size,overlap", [(8, 0.9), (5, 0.5), (30, 0.9)])
def test_collates(project, tmp_path, chunk_size, overlap):  # noqa: F811
    _, cpath, _ = project
    ds = dataset.EmbeddingDataset(Config.from_file(_with_cache(cpath, tmp_path / "c")), "test")
    items = [ds[i] for i in range(len(ds))]
    items[1] = (items[1][0], [(items[1][1][0][0], None)])  # a missing embedding
    one_row = [(9, [(77, np.ones((1, 24), np.float32))]), (8, [(78, np.zeros((1, 24)))])]
    for batch in (items, one_row):  # one-row embeddings are single fixed-shape chunks
        got = chunking.collate_overlapping(batch, chunk_size=chunk_size, overlap=overlap)
        want = jchunking.collate_overlapping(batch, chunk_size=chunk_size, overlap=overlap)
        for field in ("clique_ids", "version_ids", "embeddings", "masks", "chunk_info",
                      "chunk_valid"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert got.n_chunks == want.n_chunks
    got, want = chunking.collate_avg_pool(items[:3]), jchunking.collate_avg_pool(items[:3])
    for field in ("clique_ids", "version_ids", "embeddings", "masks"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    with pytest.raises(ValueError):
        chunking.collate_overlapping([(0, [(1, None)])])
