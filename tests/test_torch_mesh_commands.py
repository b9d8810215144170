"""The mesh paths of the port's commands on two gloo CPU ranks, held
against the JAX package's mesh paths on the 8 virtual devices and against
the port's one-process runs:

- sharded distance and top-k, blocked and not, the blocked tie order, and
  the streamed ranks (vectors and chunk sets) with the queries sharded
  equal the JAX mesh results (tests/test_parallel.py: distances rtol 1e-5
  / atol 1e-6, top-k indices equal, ranks equal);
- ``QueryEngine(mesh=)`` holds half the corpus per rank and answers as the
  one-card engine and the JAX sharded engine (tests/test_serve_cli.py::
  test_sharded_resident_corpus: full scan, rerank, pooled), and the
  ``serve --shard`` daemon on rank 0 answers with the other rank following
  its searches and its ``/reload``;
- a train step's batch arrives split over the ranks (tests/test_cli.py::
  TestTrainShardedInput), with the plain step's loss;
- ``extract --batched`` (x_concat, hs_last_seq), ``transcribe --batched``
  and ``evaluate`` launched as ``torchrun`` launches them: rank 0 alone
  prints and writes, and what it writes is what one process writes (bf16
  rows: cosine >= 0.999; transcriptions and MAP equal).

One spawn runs every case (tests/_torch_mesh_cases.py)."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from test_serve_cli import ROWS, _write_csvs
from wealy_tpu.cli import serve as jserve
from wealy_tpu.cli.main import main as jax_main
from wealy_tpu.data.embedding_store import EmbeddingStore as JStore
from wealy_tpu.ops.distance import pairwise_distance_matrix as j_pairwise
from wealy_tpu.parallel.mesh import make_mesh as j_make_mesh
from wealy_tpu.parallel.similarity import sharded_pairwise_distance as j_sharded_distance
from wealy_tpu.parallel.similarity import sharded_topk as j_sharded_topk
from wealy_tpu.parallel.similarity import streaming_relevant_ranks as j_ranks
from wealy_tpu.train.config import Config as JConfig
from wealy_tpu_torch.cli import main as tcli
from wealy_tpu_torch.cli import serve as tserve
from wealy_tpu_torch.cli.extract import load_whisper_model
from wealy_tpu_torch.data.embedding_store import EmbeddingStore
from wealy_tpu_torch.losses import get_loss
from wealy_tpu_torch.train.config import Config
from wealy_tpu_torch.train.step import make_train_step

import _torch_dp_cases as dp_cases
from _torch_parity import min_row_cosine, spawn_ranks, write_audio_project, write_embedding_project
from test_torch_serve import _jax_head_file

WORLD = 2
CONFIDENT = 128.0  # the dev decoder's final LayerNorm scale: no near-tie argmax


def _similarity_inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    sim = {"dist": (rng.normal(size=(37, 16)).astype(f), rng.normal(size=(53, 16)).astype(f)),
           "blocked": (rng.normal(size=(16, 8)).astype(f), rng.normal(size=(45, 8)).astype(f)),
           "topk": (rng.normal(size=(10, 8)).astype(f), rng.normal(size=(30, 8)).astype(f)),
           "topk_euc": (rng.normal(size=(6, 8)).astype(f), rng.normal(size=(20, 8)).astype(f)),
           "bu": (rng.normal(size=(21, 8)).astype(f), rng.normal(size=(77, 8)).astype(f))}
    r7 = np.random.default_rng(7)
    x = r7.normal(size=(8, 4)).astype(f)
    base = r7.normal(size=(40, 4)).astype(f)
    for pos in (3, 11, 19, 35):  # one copy of row 3 in each 10-wide block
        base[pos] = base[3]
    sim["tie"] = (x, base)
    S, smax, C = 19, 3, 8
    labels = np.arange(S) // 2
    centers = rng.normal(size=(S // 2 + 1, C)).astype(f)
    sets = centers[labels][:, None, :] + 0.5 * rng.normal(size=(S, smax, C)).astype(f)
    mask = np.ones((S, smax), bool)
    mask[3, 1:] = False
    sim["sets"] = (sets, labels, mask)
    sim["host"] = (rng.normal(size=(39, 16)).astype(f), np.repeat(np.arange(13), 3))
    return sim


def _jax_similarity(sim):
    mesh = j_make_mesh()
    out = {"dist": j_sharded_distance(*sim["dist"], mesh, mode="cossim"),
           "dist1": j_pairwise(*sim["dist"], mode="cossim"),
           "dist_blocked": j_sharded_distance(*sim["blocked"], mesh, mode="cos", block_size=16),
           "topk": j_sharded_topk(*sim["topk"], mesh, k=5, mode="cossim"),
           "topk_euc": j_sharded_topk(*sim["topk_euc"], mesh, k=3, mode="euc"),
           "tie": j_sharded_topk(*sim["tie"], mesh, k=6, mode="dotsim"),
           "tie_blocked": j_sharded_topk(*sim["tie"], mesh, k=6, mode="dotsim", block_size=10)}
    for mode in ("cossim", "euc"):
        out[f"bu_{mode}"] = j_sharded_topk(*sim["bu"], mesh, k=7, mode=mode)
        out[f"bb_{mode}"] = j_sharded_topk(*sim["bu"], mesh, k=7, mode=mode, block_size=16)
    sets, labels, mask = sim["sets"]
    args = dict(mode="cos", redux="smean", block_size=4, query_block=4, query_mask=mask,
                corpus_mask=mask)
    out["sets"] = j_ranks(sets, sets, labels, labels, mesh=mesh, **args)
    out["sets1"] = j_ranks(sets, sets, labels, labels, **args)
    z, labels = sim["host"]
    out["host"] = j_ranks(z, z, labels, labels, mesh=mesh, mode="cossim", block_size=10,
                          query_block=16)
    out["host1"] = j_ranks(z, z, labels, labels, mode="cossim", block_size=10)
    return jax.tree_util.tree_map(np.asarray, out)


def _serve_project(root):
    """tests/test_serve_cli.py::serve_project, for the module."""
    _write_csvs(root / "lc", ROWS)
    store = JStore(root / "hs", "lyric-covers")
    rng = np.random.default_rng(0)
    centers = {}
    for data in ROWS.values():
        for _, vid, _, _, label in data:
            centers.setdefault(label, rng.normal(size=(24,)).astype(np.float32))
            T = int(rng.integers(12, 20))
            store.save(str(vid), "hs_last_seq.npz", embeddings=centers[label][None]
                       + 0.1 * rng.normal(size=(T, 24)).astype(np.float32))
    cpath = root / "conf.json"
    cpath.write_text(json.dumps({
        "path": {"lyric_covers_data": str(root / "lc"), "hidden_states": str(root / "hs"),
                 "cache": str(root / "cache")},
        "data": {"dataset_name": "lyric-covers", "embedding_type": "last_hidden_states",
                 "embedding_format": "concat", "chunk_size": 8},
        "model": {"name": "whisper", "zdim": 16}}))
    return cpath, store


def _confident_checkpoint(path) -> str:
    model, _ = load_whisper_model("dev", seed=0, device="cpu", dtype=torch.float32)
    sd = model.state_dict()
    sd["decoder.ln.weight"] = sd["decoder.ln.weight"] * CONFIDENT
    torch.save(sd, path)
    return str(path)


def _commands(conf, ckpt, eval_conf) -> list:
    cpu = ["--device", "cpu"]
    return [
        ["extract", "--config", conf, "--split", "train", "--batched", "--batch-size", "4",
         "--kinds", "x_concat", *cpu],
        ["extract", "--config", conf, "--split", "train", "--batched", "--batch-size", "4",
         "--kinds", "hs_last_seq", "--hf-checkpoint", ckpt, *cpu],
        ["transcribe", "--config", conf, "--split", "train", "--greedy", "--batched",
         "--batch-size", "2", "--max-len", "12", "--hf-checkpoint", ckpt, *cpu],
        ["evaluate", "--config", eval_conf, "--split", "test", "--encode-slab", "4", *cpu],
        ["evaluate", "--config", eval_conf, "--split", "test", "--encode-slab", "4",
         "--streaming", *cpu],
        ["evaluate", "--config", eval_conf, "--split", "test", "--encode-slab", "4",
         "--streaming", "--chunk-sets", *cpu],
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    sim = _similarity_inputs()
    # the serving project, the JAX index and its head carried across
    cpath, store = _serve_project(work / "serve")
    index = work / "serve" / "idx.npz"
    assert jax_main(["index", "--config", str(cpath), "--split", "test", "--out",
                     str(index)]) == 0
    head = _jax_head_file(cpath, work / "serve")
    with np.load(store.path("500", "hs_last_seq.npz")) as d:
        seq = d["embeddings"]
    options = ({}, {"rerank": 3}, {"pooled": True})
    jconfig = JConfig.from_dict(json.loads(cpath.read_text()))
    jeng = jserve.QueryEngine(jconfig, str(index), None, block_size=2, mesh=j_make_mesh())
    ref = {"sim": _jax_similarity(sim),
           "serve_jax": [jeng.search(seq, k=4, **kw) for kw in options]}
    config = Config.from_dict(json.loads(cpath.read_text()))
    one = tserve.QueryEngine(config, str(index), head, block_size=2, device="cpu")
    ref["serve_one"] = [one.search(seq, k=4, **kw) for kw in options]

    # the command runs: the mesh's store and the one process's
    conf = write_audio_project(work / "audio")
    ckpt = _confident_checkpoint(work / "confident.pt")
    (work / "eval").mkdir()
    eval_conf = write_embedding_project(work / "eval")
    mesh_cmds = _commands(conf("mesh"), ckpt, eval_conf)
    ref["cli_one"] = []
    for argv in _commands(conf("one"), ckpt, eval_conf):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tcli.main(argv)
        ref["cli_one"].append([rc, buf.getvalue().strip().splitlines()])
    torch.save({"sim": sim, "cli": mesh_cmds,
                "serve": {"cpath": str(cpath), "index": str(index), "head": head, "seq": seq,
                          "options": options}}, work / "inputs.pt")
    results = spawn_ranks("_torch_mesh_cases", WORLD, work, n_ports=1 + len(mesh_cmds))
    return ref, results, work


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


class TestShardedSimilarity:
    def test_matches_single_device(self, ranks):
        ref, results, _ = ranks
        for res in results:
            assert tuple(res["sim"]["dist"].shape) == (37, 53)
            _close(res["sim"]["dist"], ref["sim"]["dist"])
            _close(res["sim"]["dist"], ref["sim"]["dist1"])

    def test_blocked_matches(self, ranks):
        ref, results, _ = ranks
        for res in results:
            _close(res["sim"]["dist_blocked"], ref["sim"]["dist_blocked"])

    @pytest.mark.parametrize("name,tol", [("topk", 1e-5), ("topk_euc", 1e-4)])
    def test_topk(self, ranks, name, tol):
        ref, results, _ = ranks
        for res in results:
            vals, idx = res["sim"][name]
            _close(vals, ref["sim"][name][0], rtol=tol, atol=tol / 10)
            np.testing.assert_array_equal(idx.numpy(), ref["sim"][name][1])

    @pytest.mark.parametrize("mode", ["cossim", "euc"])
    def test_topk_blocked_matches_unblocked(self, ranks, mode):
        ref, results, _ = ranks
        for res in results:
            (bv, bi), (uv, ui) = res["sim"][f"bb_{mode}"], res["sim"][f"bu_{mode}"]
            np.testing.assert_array_equal(bi.numpy(), ui.numpy())
            np.testing.assert_array_equal(bi.numpy(), ref["sim"][f"bb_{mode}"][1])
            _close(bv, uv, rtol=1e-6, atol=1e-7)
            _close(bv, ref["sim"][f"bb_{mode}"][0])

    def test_topk_blocked_tie_order(self, ranks):
        """Duplicated scores keep the earliest column first across block
        boundaries, blocked or not, as the JAX top-k does. (A block's product
        has another shape than the whole one, so its scores may differ in
        the last bit: within the blocked test's rtol 1e-6.)"""
        ref, results, _ = ranks
        for res in results:
            (bv, bi), (uv, ui) = res["sim"]["tie_blocked"], res["sim"]["tie"]
            np.testing.assert_array_equal(bi.numpy(), ui.numpy())
            _close(bv, uv, rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(bi.numpy(), ref["sim"]["tie_blocked"][1])

    def test_mesh_chunk_sets(self, ranks):
        ref, results, _ = ranks
        for res in results:
            r, n = res["sim"]["sets"]
            for want in (ref["sim"]["sets"], ref["sim"]["sets1"]):
                np.testing.assert_array_equal(r, want[0])
                np.testing.assert_array_equal(n, want[1])

    def test_mesh_matches_host(self, ranks):
        ref, results, _ = ranks
        for res in results:
            r, n = res["sim"]["host"]
            for want in (ref["sim"]["host"], ref["sim"]["host1"]):
                np.testing.assert_array_equal(r, want[0])
                np.testing.assert_array_equal(n, want[1])


def _same_results(got, want, atol=1e-4):
    assert [r["version_key"] for r in got["results"]] == \
        [r["version_key"] for r in want["results"]], (got, want)
    np.testing.assert_allclose([r["score"] for r in got["results"]],
                               [r["score"] for r in want["results"]], atol=atol)


class TestShardedServing:
    def test_sharded_resident_corpus(self, ranks):
        """Corpus 4 < block 2 x 2 ranks: rank 1 holds only padding rows, the
        hardest seam (the JAX test's 8-device case)."""
        ref, results, _ = ranks
        for res in results:
            assert res["serve"]["n_local"] == 2
            for got, one, jax_ in zip(res["serve"]["search"], ref["serve_one"],
                                      ref["serve_jax"]):
                _same_results(got, one, atol=1e-6)
                _same_results(got, jax_)

    def test_shard_daemon_answers_from_rank_0(self, ranks):
        ref, results, _ = ranks
        answers = results[0]["serve"]["daemon"]
        assert len(answers) == 3 and answers[1]["ok"] and answers[1]["indexed"] == 4
        for a in (answers[0], answers[2]):
            _same_results(a, ref["serve_one"][0], atol=1e-6)
        assert results[1]["serve"]["daemon"] == []  # rank 1 followed, it did not serve


def test_batches_arrive_sharded(ranks):
    _, results, _ = ranks
    state, ld = make_train_step(None, get_loss("clews"))(dp_cases.head_state(),
                                                         dp_cases.head_batch())
    for res in results:
        assert res["train"]["rows"] == [dp_cases.B // WORLD]
        assert abs(res["train"]["loss"] - float(ld["loss"])) < 1e-6


def _store(work, name):
    return EmbeddingStore(work / "audio" / name, "lyric-covers")


@pytest.mark.parametrize("i,kind", [(0, "x_concat"), (1, "hs_last_seq")])
def test_extract_on_a_data_mesh_writes_what_one_process_writes(ranks, i, kind):
    ref, results, work = ranks
    (rc0, out0), (rc1, out1) = (res["cli"][i] for res in results)
    rc, out = ref["cli_one"][i]
    assert rc0 == rc1 == rc == 0 and out1 == []  # rank 0 alone prints
    got, want = json.loads(out0[-1]), json.loads(out[-1])
    assert got["done"] == want["done"] == 2 and got["incomplete"] == []
    assert got["throughput"]["total_items"] == want["throughput"]["total_items"]
    for v in ("100", "101"):
        a = _store(work, "mesh").load(v, f"{kind}.npz")["embeddings"]
        b = _store(work, "one").load(v, f"{kind}.npz")["embeddings"]
        assert a.shape == b.shape
        live = np.abs(b).sum(axis=-1) > 0  # positions past a chunk's end are zero rows
        np.testing.assert_array_equal(np.abs(a).sum(axis=-1) > 0, live)
        assert min_row_cosine(a[live], b[live]) >= 0.999


def test_transcribe_on_a_data_mesh_writes_what_one_process_writes(ranks):
    ref, results, work = ranks
    (rc0, out0), (rc1, out1) = (res["cli"][2] for res in results)
    rc, out = ref["cli_one"][2]
    assert rc0 == rc1 == rc == 0 and out1 == []
    got, want = json.loads(out0[-1]), json.loads(out[-1])
    for k in ("done", "skipped", "failed", "n_valid", "n_total"):
        assert got[k] == want[k], k
    trees = [sorted((p.name, p.read_text()) for p in
                    (work / "audio" / f"cache_{name}" / "transcriptions").rglob("*.txt"))
             for name in ("mesh", "one")]
    assert trees[0] == trees[1] and len(trees[0]) == 2


@pytest.mark.parametrize("i", [3, 4, 5])
def test_evaluate_on_a_data_mesh_equals_one_process(ranks, i):
    ref, results, _ = ranks
    (rc0, out0), (rc1, out1) = (res["cli"][i] for res in results)
    rc, out = ref["cli_one"][i]
    assert rc0 == rc1 == rc == 0 and out1 == []
    got, want = json.loads(out0[-1]), json.loads(out[-1])
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6, (k, got, want)
