"""CPU parity of the port's evaluate path against the JAX package:
rank_metrics, regroup_chunks, the streamed and resident chunk-set rank
passes (ranks identical, ties across blocks included), and the
``evaluate`` CLI on the fixture of tests/test_cli.py::project with the same
head weights (an orbax checkpoint for JAX, its torch conversion for the
port): MAP, MR1 and P@10 equal to 1e-6."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.cli.main import main as jax_main
from wealy_tpu.eval import retrieval as jretrieval
from wealy_tpu.models.heads import ProjectionHead as JProjectionHead
from wealy_tpu.parallel import similarity as jsimilarity
from wealy_tpu.train.checkpoint import CheckpointManager
from wealy_tpu_torch.cli import main as tcli
from wealy_tpu_torch.eval import retrieval
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params
from wealy_tpu_torch.parallel import similarity

from test_cli import project  # noqa: F401  (the shared fixture)


def test_rank_metrics_and_average_precision():
    rng = np.random.default_rng(0)
    dist = rng.uniform(size=(12, 15)).astype(np.float32)
    dist[3, 4] = dist[3, 5]  # a tie
    ql, cl = rng.integers(0, 4, 12), rng.integers(0, 4, 15)
    qi, ci = np.arange(12), np.arange(15)
    got = retrieval.rank_metrics(dist, ql, cl, qi, ci, topk=(1, 5, 10))
    assert got == jretrieval.rank_metrics(dist, ql, cl, qi, ci, topk=(1, 5, 10))
    rel = np.array([0, 1, 0, 1, 1], bool)
    assert retrieval.average_precision(rel) == jretrieval.average_precision(rel)
    assert retrieval.average_precision(np.zeros(3, bool)) == 0.0


def test_regroup_chunks():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(10, 4)).astype(np.float32)
    info = np.array([[0, 0, 0], [0, 0, 1], [1, 0, 0], [0, 0, 2], [2, 0, 0], [2, 0, 1],
                     [1, 0, 1], [-1, -1, -1], [-1, -1, -1], [3, 0, 0]])
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0, 0, 1], bool)
    for got, want in zip(retrieval.regroup_chunks(z, info, valid),
                         jretrieval.regroup_chunks(z, info, valid)):
        np.testing.assert_array_equal(got, want)


def _chunk_sets(rng, S=30, smax=5, C=12, n_cliques=10):
    labels = np.repeat(np.arange(n_cliques), S // n_cliques)
    base = rng.normal(size=(n_cliques, C)).astype(np.float32)
    sets = np.zeros((S, smax, C), np.float32)
    mask = np.zeros((S, smax), bool)
    for i in range(S):
        n = int(rng.integers(1, smax + 1))
        sets[i, :n] = base[labels[i]][None] + 0.6 * rng.normal(size=(n, C))
        mask[i, :n] = True
    # exact duplicates across cliques and blocks: equal scores, tie order
    sets[5], mask[5] = sets[2], mask[2]
    sets[29], mask[29] = sets[2], mask[2]
    sets[10], mask[10] = sets[9], mask[9]
    return sets, mask, labels


@pytest.mark.parametrize("redux", ["bpwr", "bpwr-2", "smean"])
@pytest.mark.parametrize("resident", [False, True])
def test_streaming_chunk_set_ranks(redux, resident):
    rng = np.random.default_rng(2)
    sets, mask, labels = _chunk_sets(rng)
    ids = np.arange(len(labels)) + 100
    kw = dict(mode="cos", redux=redux, block_size=7, query_block=11, query_idx=ids,
              corpus_idx=ids, query_mask=mask, corpus_mask=mask)
    want, wn = jsimilarity.streaming_relevant_ranks(sets, sets, labels, labels, **kw)
    got, gn = similarity.streaming_relevant_ranks(sets, sets, labels, labels, resident=resident,
                                                  device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gn, wn)
    # and the monolithic path: the same metrics from the full matrix
    d = retrieval.song_distance_matrix(sets, mask, sets, mask, redux=redux, device="cpu")
    mono = retrieval.rank_metrics(d, labels, labels, ids, ids, topk=(10,))
    streamed = similarity.map_from_ranks(got, gn, topk=(10,))
    for k in ("MAP", "MR1", "P@10", "n_queries"):
        assert abs(streamed[k] - mono[k]) < 1e-9


@pytest.mark.parametrize("mode", ["cos", "cossim"])
def test_streaming_vector_ranks_with_ties(mode):
    rng = np.random.default_rng(3)
    labels = np.repeat(np.arange(12), 4)
    z = rng.normal(size=(48, 16)).astype(np.float32)
    for c in range(12):
        z[labels == c] += 2.0 * rng.normal(size=16).astype(np.float32)
    z[5], z[9], z[30], z[44] = z[2], z[8], z[2], z[45]
    kw = dict(mode=mode, block_size=5, query_block=7)
    want, wn = jsimilarity.streaming_relevant_ranks(z, z, labels, labels, **kw)
    for resident in (False, True):
        got, gn = similarity.streaming_relevant_ranks(z, z, labels, labels, resident=resident,
                                                      device="cpu", **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gn, wn)
    assert similarity.map_from_ranks(got, gn, topk=(1, 10)) == \
        jsimilarity.map_from_ranks(want, wn, topk=(1, 10))


def test_relevant_columns_cap_logs(caplog):
    labels = np.array([0, 0, 0, 0, 1, 1])
    got = similarity.relevant_columns(labels, labels, max_relevant=2)
    want = jsimilarity.relevant_columns(labels, labels, max_relevant=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert "truncates" in caplog.text


def test_block_and_query_padding_helpers():
    assert tcli._set_block_size(18) == 222  # the (222, 222, 18, 18) block, 64 MB f32
    assert tcli._set_block_size(1) == 2048 and tcli._set_block_size(500) == 16
    sets, mask = tcli._pad_chunk_sets([np.ones((2, 3, 4)), np.ones((1, 5, 4))],
                                      [np.ones((2, 3), bool), np.ones((1, 5), bool)], 3)
    assert sets.shape == (3, 5, 4) and mask.sum() == 11


def _checkpoints(root, zdim=16, emb=24, L=8):
    """The same head weights for both sides: a flax init saved with orbax,
    and its conversion saved as a torch state dict."""
    head = JProjectionHead(zdim=zdim)
    params = head.init(jax.random.PRNGKey(7), jnp.zeros((1, L, emb)), jnp.ones((1, L), bool))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    CheckpointManager(root / "orbax").save(0, {"params": params})
    torch.save(head_state_dict_from_jax_params(params), root / "head.pt")
    return str(root / "orbax"), str(root / "head.pt")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--redux", "bpwr"],
    ["--redux", "bpwr", "--streaming", "--chunk-sets"],
    ["--redux", "smean"],
    ["--streaming"],
])
def test_evaluate_cli_matches_jax(project, capsys, flags):  # noqa: F811
    root, cpath, _ = project
    orbax_dir, torch_file = _checkpoints(root)
    base = ["evaluate", "--config", str(cpath), "--split", "test"]
    assert jax_main(base + ["--checkpoint", orbax_dir] + flags) == 0
    want = _last_json(capsys)
    assert tcli.main(base + ["--checkpoint", torch_file, "--device", "cpu"] + flags) == 0
    got = _last_json(capsys)
    assert got["n_queries"] == want["n_queries"] == 4
    for k in ("MAP", "MR1", "P@10"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)


def test_evaluate_cli_avg_pooling_and_paths_agree(project, capsys, tmp_path):  # noqa: F811
    """use_avg_pooling against JAX; and, with the seeded init, the port's
    monolithic and streamed chunk-set runs agree exactly."""
    root, cpath, _ = project
    orbax_dir, torch_file = _checkpoints(root)
    conf = json.loads(cpath.read_text())
    conf["data"]["use_avg_pooling"] = True
    avg = tmp_path / "avg.json"
    avg.write_text(json.dumps(conf))
    base = ["evaluate", "--config", str(avg), "--split", "test", "--redux", "smean"]
    assert jax_main(base + ["--checkpoint", orbax_dir]) == 0
    want = _last_json(capsys)
    assert tcli.main(base + ["--checkpoint", torch_file, "--device", "cpu"]) == 0
    got = _last_json(capsys)
    for k in ("MAP", "MR1", "P@10"):
        assert abs(got[k] - want[k]) <= 1e-6
    runs = []
    for flags in ([], ["--streaming", "--chunk-sets"]):
        assert tcli.main(["evaluate", "--config", str(cpath), "--song-group", "3",
                          "--encode-slab", "5", "--device", "cpu"] + flags) == 0
        runs.append(_last_json(capsys))
    assert runs[0] == runs[1]


def test_validate_data_cli_matches_jax(project, capsys):  # noqa: F811
    _, cpath, _ = project
    assert jax_main(["validate-data", "--config", str(cpath)]) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(["validate-data", "--config", str(cpath)]) == 0
    assert json.loads(capsys.readouterr().out) == want


def test_evaluate_cli_test_mode_and_fusion_names_run(project, tmp_path, capsys):  # noqa: F811
    """What was refused before the CLEWS/fusion slice now runs as in JAX:
    ``--test-mode`` leaves the whisper head's evaluate as it is (JAX ignores
    it for a single-modal model), and a fusion name evaluates (its metrics
    against JAX are in tests/test_torch_fusion_cli.py)."""
    root, cpath, _ = project
    orbax_dir, torch_file = _checkpoints(root)
    base = ["evaluate", "--config", str(cpath), "--split", "test"]
    assert jax_main(base + ["--checkpoint", orbax_dir, "--test-mode"]) == 0
    want = _last_json(capsys)
    assert tcli.main(base + ["--checkpoint", torch_file, "--test-mode", "--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert tcli.main(base + ["--checkpoint", torch_file, "--device", "cpu"]) == 0
    assert _last_json(capsys) == got
    for k in ("MAP", "MR1", "P@10"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)
    conf = json.loads(cpath.read_text())
    conf["model"]["name"] = "wealy-clews"
    conf["path"]["checkpoints"] = str(tmp_path / "none")
    other = tmp_path / "clews.json"
    other.write_text(json.dumps(conf))
    assert tcli.main(["evaluate", "--config", str(other), "--device", "cpu"]) == 0
    fused = _last_json(capsys)
    assert fused["n_queries"] == 4 and 0.0 < fused["MAP"] <= 1.0


def test_auto_streaming_threshold():
    args = tcli.build_parser().parse_args(["evaluate", "--config", "c.json"])
    tcli._auto_streaming(args, tcli.AUTO_STREAM_THRESHOLD, exact_chunk_sets=True)
    assert not args.streaming
    tcli._auto_streaming(args, tcli.AUTO_STREAM_THRESHOLD + 1, exact_chunk_sets=True)
    assert args.streaming and args.chunk_sets
    args = tcli.build_parser().parse_args(["evaluate", "--config", "c.json", "--no-streaming"])
    tcli._auto_streaming(args, 10**6)
    assert not args.streaming
