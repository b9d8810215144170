"""The port's packed store writer (wealy_tpu_torch.data.packed_store:
PackWriter, PackedStore.pack, pack_from_store, the ``pack`` command)
against the JAX package's: the same per-version store packs to byte-equal
binaries and equal manifests, each package reads the other's pack, and the
writer's cases of tests/test_extract_batched.py (resume from an old pack,
abort, the old pack readable until close) hold in the port."""

import json

import numpy as np
import pytest

from wealy_tpu.data.embedding_store import EmbeddingStore as JStore
from wealy_tpu.data.packed_store import PackedStore as JPacked
from wealy_tpu.data.packed_store import PackWriter as JWriter
from wealy_tpu.data.packed_store import pack_from_store as j_pack_from_store
from wealy_tpu_torch.data.embedding_store import EmbeddingStore
from wealy_tpu_torch.data.packed_store import PackedStore, PackWriter, pack_from_store

# (version, shape) per kind: sequences, 1-D vectors, and hs_last_all's 3-D layout
SHAPES = {
    "hs_last_seq": [("100", (17, 8)), ("101", (1, 8)), ("200", (40, 8)), ("201", (3, 8))],
    "hs_clews_avg": [("100", (8,)), ("101", (8,)), ("200", (8,)), ("201", (8,))],
    "hs_last_all": [("100", (2, 5, 8)), ("101", (1, 5, 8)), ("200", (3, 5, 8)),
                    ("201", (1, 5, 8))],
}


def _store(root, kind, missing=("201",)):
    store = EmbeddingStore(root, "lyric-covers")
    rng = np.random.default_rng(len(kind))
    for v, shape in SHAPES[kind]:
        if v not in missing:
            store.save(v, f"{kind}.npz", embeddings=rng.normal(size=shape).astype(np.float32))
    return store


@pytest.mark.parametrize("dataset", ["lyric-covers", None])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_pack_from_store_byte_equal_to_jax(tmp_path, kind, dataset):
    """Both writers over one store (a missing version, a duplicate key): the
    same binary bytes and the same manifest, read back equal by both
    readers."""
    _store(tmp_path / "hs", kind)
    versions = ["200", "100", "101", "100", "201"]
    ours = pack_from_store(EmbeddingStore(tmp_path / "hs", "lyric-covers"), versions,
                           f"{kind}.npz", tmp_path / "port", dataset_name=dataset)
    theirs = j_pack_from_store(JStore(tmp_path / "hs", "lyric-covers"), versions,
                               f"{kind}.npz", tmp_path / "jax", dataset_name=dataset)
    assert ours.bin_path.name == theirs.bin_path.name
    assert ours.bin_path.read_bytes() == theirs.bin_path.read_bytes()
    assert json.loads(ours.manifest_path.read_text()) == json.loads(
        theirs.manifest_path.read_text())
    assert len(ours) == 3 and "201" not in ours
    for v in ("100", "101", "200"):
        want = JStore(tmp_path / "hs", "lyric-covers").load(v, f"{kind}.npz")["embeddings"]
        np.testing.assert_array_equal(ours.load(v), want)
        np.testing.assert_array_equal(ours.load(v), theirs.load(v))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_pack(tmp_path, writer):
    rng = np.random.default_rng(1)
    rows = [("a", rng.normal(size=(6, 4))), ("b", rng.normal(size=(4,))),
            ("c", rng.normal(size=(2, 3, 4)))]
    pack = (PackedStore if writer == "port" else JPacked).pack
    pack(tmp_path, "k.npz", rows, dataset_name="d")
    for reader in (PackedStore, JPacked):
        got = reader(tmp_path, "k", dataset_name="d")
        assert got.available and len(got) == 3
        for key, arr in rows:
            np.testing.assert_array_equal(got.load(key), arr.astype(np.float16).astype(np.float32))
            assert got.load(key, dtype=np.float16).dtype == np.float16


def test_seed_from_carries_an_old_pack_forward(tmp_path):
    old = PackedStore.pack(tmp_path, "x_concat", [("100", np.full((1, 2), 7.0, np.float32))],
                           dataset_name="lyric-covers")
    writer = PackWriter(tmp_path, "x_concat", dataset_name="lyric-covers")
    assert writer.seed_from(old, ["100", "999"]) == 1
    assert "100" in writer and len(writer) == 1
    writer.add("101", np.ones((3, 2), np.float32))
    packed = writer.close()
    np.testing.assert_allclose(packed.load("100"), 7.0)
    assert packed.load("101").shape == (3, 2)
    # the JAX writer given the same rows writes the same bytes
    jw = JWriter(tmp_path / "j", "x_concat", dataset_name="lyric-covers")
    jw.seed_from(JPacked(tmp_path, "x_concat", dataset_name="lyric-covers"), ["100", "101"])
    assert jw.close().bin_path.read_bytes() == packed.bin_path.read_bytes()


def test_abort_leaves_no_pack(tmp_path):
    writer = PackWriter(tmp_path, "k", dataset_name="d")
    writer.add("a", np.ones((2, 4), np.float32))
    writer.abort()
    assert not PackedStore(tmp_path, "k", dataset_name="d").available
    assert not list(tmp_path.glob(".*tmp"))


def test_an_exception_in_the_with_block_aborts_and_goes_on(tmp_path):
    PackedStore.pack(tmp_path, "k", [("a", np.full((1, 4), 1.0))], dataset_name="d")
    with pytest.raises(RuntimeError, match="boom"):
        with PackWriter(tmp_path, "k", dataset_name="d") as writer:
            writer.add("a", np.full((1, 4), 2.0))
            raise RuntimeError("boom")
    assert not list(tmp_path.glob(".*tmp"))
    np.testing.assert_allclose(PackedStore(tmp_path, "k", dataset_name="d").load("a"), 1.0)


def test_old_pack_readable_until_close(tmp_path):
    PackedStore.pack(tmp_path, "k", [("a", np.full((1, 4), 1.0))], dataset_name="d")
    writer = PackWriter(tmp_path, "k", dataset_name="d")
    writer.add("a", np.full((1, 4), 2.0))
    for reader in (PackedStore, JPacked):
        np.testing.assert_allclose(reader(tmp_path, "k", dataset_name="d").load("a"), 1.0)
    writer.close()
    for reader in (PackedStore, JPacked):
        np.testing.assert_allclose(reader(tmp_path, "k", dataset_name="d").load("a"), 2.0)


def test_duplicate_keys_pack_once_and_dims_must_agree(tmp_path):
    writer = PackWriter(tmp_path, "k")
    writer.add("a", np.full((2, 4), 1.0))
    writer.add("a", np.full((5, 4), 9.0))  # the first occurrence wins
    with pytest.raises(ValueError, match="inconsistent embedding dim"):
        writer.add("b", np.ones((1, 3)))
    packed = writer.close()
    assert len(packed) == 1 and packed.load("a").shape == (2, 4)
    np.testing.assert_allclose(packed.load("a"), 1.0)
    assert packed.bin_path.stat().st_size == 2 * 4 * 2  # f16 rows, written once
    assert packed.bin_path.name == "packed_k.bin" and not list(tmp_path.glob(".*tmp"))


def test_a_torn_pack_reads_as_absent(tmp_path):
    """A binary replaced without its manifest (a crash between the two
    renames) is refused by both readers."""
    packed = PackedStore.pack(tmp_path, "k", [("a", np.ones((3, 4)))], dataset_name="d")
    packed.bin_path.write_bytes(np.zeros((5, 4), np.float16).tobytes())
    assert not PackedStore(tmp_path, "k", dataset_name="d").available
    assert not JPacked(tmp_path, "k", dataset_name="d").available


def test_converting_loads_read_the_file_and_map_nothing(tmp_path):
    """A load in another dtype reads its rows from the file (equal to the
    JAX reader's), so a stream over the pack keeps no memory map resident;
    a load in the pack's own dtype is a view of the map."""
    rng = np.random.default_rng(4)
    arrays = [(f"v{i}", rng.normal(size=(int(rng.integers(1, 6)), 8)).astype(np.float16))
              for i in range(12)] + [("flat", rng.normal(size=8).astype(np.float16))]
    PackedStore.pack(tmp_path, "hs_last_seq", arrays)
    store, jstore = PackedStore(tmp_path, "hs_last_seq"), JPacked(tmp_path, "hs_last_seq")
    for key, arr in arrays:
        got = store.load(key)
        assert got.dtype == np.float32 and got.shape == arr.shape
        np.testing.assert_array_equal(got, jstore.load(key))
    assert store._mmap is None
    view = store.load("v3", dtype=np.float16)
    np.testing.assert_array_equal(view, dict(arrays)["v3"])
    assert isinstance(view.base, np.memmap) or isinstance(view, np.memmap)
